"""The port's host tools against the JAX package's, on the CPU:
tools/model_check.py and tools/tokenizer_check.py print the same lines and
return the same codes on the same synthetic checkpoint; the native C++
encode core (tokenizer/native.py) gives the Python encode's ids on the texts
and seeds of tests/test_tokenizer.py::test_native_matches_python; the CLI's
--profile writes a torch.profiler trace and prints the same tokens as
without it."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu.tools import model_check as jax_model_check  # noqa: E402
from qwen3_tpu.tools import tokenizer_check as jax_tokenizer_check  # noqa: E402
from qwen3_tpu_torch.cli import main as cli  # noqa: E402
from qwen3_tpu_torch.config import PRESETS, native_tokenizer_from_env  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu_torch.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu_torch.io.tokenizer_bin import (  # noqa: E402
    dumps_tokenizer_bin,
    write_tokenizer_bin,
)
from qwen3_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from qwen3_tpu_torch.tokenizer.native import load_native  # noqa: E402
from qwen3_tpu_torch.tools import model_check, tokenizer_check  # noqa: E402


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = PRESETS["tiny"]
    path = str(tmp_path_factory.mktemp("torch_tools") / "tiny.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=5))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("extra", [[], ["64"], ["100000"]])
def test_model_check_matches_jax(ckpt, capsys, extra):
    """The header line, per-tensor byte lines and total; a seq_len argument
    clamped to the checkpoint's maximum as the JAX tool clamps it."""
    want = _run(jax_model_check.main, [ckpt] + extra, capsys)
    got = _run(model_check.main, [ckpt] + extra, capsys)
    assert got == want
    assert got[0] == 0 and "[Weights] total" in got[2]


def test_model_check_failures_match_jax(tmp_path, capsys):
    """A missing file returns 1 with the FAILED line, no argument 2 with the
    usage line (which names each tool's own module)."""
    bad = str(tmp_path / "missing.bin")
    want = _run(jax_model_check.main, [bad], capsys)
    got = _run(model_check.main, [bad], capsys)
    assert got[0] == want[0] == 1
    assert got[2].splitlines()[0] == want[2].splitlines()[0]
    rc, out, err = _run(model_check.main, [], capsys)
    assert rc == 2 and "qwen3_tpu_torch.tools.model_check" in err


TEXTS = ["the cat in the hat", "<|im_start|>user\nhi<|im_end|>",
         "héllo wörld", "a < b > c", "<think>\n\n</think>\n"]


def test_tokenizer_check_matches_jax(ckpt, capsys):
    want = _run(jax_tokenizer_check.main, [ckpt] + TEXTS, capsys)
    got = _run(tokenizer_check.main, [ckpt] + TEXTS, capsys)
    assert got == want
    assert got[0] == 0 and got[1].count("[ok]") == len(TEXTS)
    rc, _, err = _run(tokenizer_check.main, [ckpt], capsys)
    assert rc == 2 and "qwen3_tpu_torch.tools.tokenizer_check" in err


@pytest.fixture(scope="module")
def tok_data():
    return synthetic_tokenizer(PRESETS["tiny"].vocab_size)


def test_native_matches_python(tok_data):
    """The native C++ encode core against the Python encode, on
    tests/test_tokenizer.py::test_native_matches_python's texts and
    seeds."""
    if shutil.which("g++") is None:
        pytest.skip("native tokenizer unavailable (no g++)")
    native = load_native(dumps_tokenizer_bin(tok_data))
    assert native is not None
    tok = Tokenizer(tok_data, use_native=False)
    assert native.vocab_size == tok.vocab_size
    texts = TEXTS + [""]
    alphabet = b"the and in on er at reding \n<>|"
    for seed in range(6):
        r = np.random.default_rng(seed)
        n = int(r.integers(1, 300))
        texts.append(bytes(r.choice(list(alphabet), size=n).tolist()))
    for text in texts:
        assert native.encode(text) == tok.encode_python(text), text
    on = Tokenizer(tok_data)                    # the library default
    assert on._native is not None
    for text in texts:
        assert on.encode(text) == tok.encode(text), text


def test_native_flag_is_read_by_the_entry_points_only(tok_data):
    """QWEN3_TPU_NATIVE_TOKENIZER as the JAX package reads it: "1" (the
    default) on, anything else off; use_native=False keeps the Python
    encode."""
    assert native_tokenizer_from_env({}) is True
    assert native_tokenizer_from_env({"QWEN3_TPU_NATIVE_TOKENIZER": "1"})
    assert not native_tokenizer_from_env({"QWEN3_TPU_NATIVE_TOKENIZER": "0"})
    assert Tokenizer(tok_data, use_native=False)._native is None


def test_cli_profile_writes_a_trace(ckpt, tmp_path, capsysbinary):
    """--profile DIR on --device cpu: the [Profile] line, a Chrome trace
    with the forward's ops in DIR, and the same stdout as without it."""
    args = [ckpt, "-m", "completion", "-i", "the cat", "-t", "0.8", "-s",
            "3", "-c", "64", "--max-tokens", "8", "--device", "cpu"]
    assert cli(args) == 0
    want = capsysbinary.readouterr().out
    pdir = tmp_path / "prof"
    assert cli(args + ["--profile", str(pdir)]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    assert f"[Profile] tracing to {pdir}".encode() in got.err
    traces = list(Path(pdir).glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
