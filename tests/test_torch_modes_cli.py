"""The entry points in modes exact, bf16 and pallas-int8, against the JAX
package's on the `tiny` synthetic checkpoint, on the CPU: the CLI's
completion stdout in --qmode exact, bf16 and pallas-int8 and with
QWEN3_TPU_FUSE=1 in pallas and pallas-fast, and serve.py's records in
--qmode pallas-int8 and bf16; what the port still refuses; how the entry
points read QWEN3_TPU_FUSE.

The (prompt, seed) pairs are ones without a Q8 or bf16 rounding flip between
the two packages (ROADMAP.md Queue C #1); under bf16 and pallas-int8
(attention with bf16 dot operands) flips are frequent, and other seeds
diverge after a few tokens.
"""

import io
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from qwen3_tpu.cli import main as jax_cli  # noqa: E402
from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.serve import main as jax_serve  # noqa: E402
from qwen3_tpu_torch.cli import main as cli  # noqa: E402
from qwen3_tpu_torch.config import fuse_from_env  # noqa: E402
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402
from qwen3_tpu_torch.serve import main as serve  # noqa: E402

PROMPT = "in the beginning"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops, which gain nothing from
    intra-op threads and lose much to them when the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, tiny_weights, tiny_tok):
    d = tmp_path_factory.mktemp("torch_modes_cli")
    path = str(d / "tiny.bin")
    write_checkpoint(path, tiny_weights)
    write_tokenizer_bin(path + ".tokenizer", tiny_tok)
    return path


@pytest.fixture
def fuse_env(monkeypatch):
    """Sets QWEN3_TPU_FUSE for both packages: the JAX package reads it
    while tracing, so its jit caches are cleared before and after."""
    def set_fuse(value):
        jax.clear_caches()
        monkeypatch.setenv("QWEN3_TPU_FUSE", value)
    yield set_fuse
    monkeypatch.delenv("QWEN3_TPU_FUSE", raising=False)
    jax.clear_caches()


@pytest.mark.parametrize("qmode,fuse,seed,temperature", [
    ("exact", "0", 3, "0.8"), ("bf16", "0", 3, "0.8"),
    ("pallas-int8", "0", 3, "0.8"), ("pallas-int8", "0", 42, "0"),
    ("pallas", "1", 3, "0.8"), ("pallas-fast", "1", 3, "0.8")])
def test_cli_stdout_matches_jax(ckpt, capsysbinary, fuse_env, qmode, fuse,
                                seed, temperature):
    """`python -m qwen3_tpu_torch.cli` and `python -m qwen3_tpu.cli` with
    the same flags and the same environment print the same bytes."""
    fuse_env(fuse)
    args = [ckpt, "-m", "completion", "-i", PROMPT, "-t", temperature,
            "-s", str(seed), "-c", "64", "--qmode", qmode,
            "--max-tokens", "16"]
    assert jax_cli(args) == 0
    want = capsysbinary.readouterr().out
    assert cli(args + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    assert f"mode={qmode}".encode() in got.err
    assert f"fuse={fuse}".encode() in got.err


def _serve_records(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return [{k: r[k] for k in ("id", "prompt", "text", "n_tokens")}
            for r in map(json.loads, out.splitlines())]


@pytest.mark.parametrize("qmode,temperature", [
    ("pallas-int8", "0.9"), ("pallas-int8", "0"), ("bf16", "0")])
def test_serve_records_match_jax(ckpt, tmp_path, capsys, qmode, temperature):
    """serve.py in --qmode pallas-int8 (attention with bf16 dot operands,
    auto -> fused) and bf16 prints the JAX serve's records; seeded, the seed
    of line i is -s + i (30 and 31 here, flip-free)."""
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("in the hat and\nthe the the\n")
    argv = [ckpt, "-t", temperature, "-s", "30", "-c", "96",
            "--max-tokens", "12", "--batch", "3", "--prefill-bucket", "16",
            "--decode-chunk", "8", "--qmode", qmode, "--prompts", str(pfile)]
    want = _serve_records(jax_serve, argv, capsys)
    got = _serve_records(serve, argv + ["--device", "cpu"], capsys)
    assert len(got) == 2
    assert got == want


def test_serve_with_fuse_prints_the_unfused_records(ckpt, tmp_path, capsys,
                                                    fuse_env):
    """QWEN3_TPU_FUSE=1 changes the kernels serve.py launches, not its
    output: the fused matmuls give the unfused chain's bits."""
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("in the hat and\nthe cat\n")
    argv = [ckpt, "-t", "0.9", "-s", "5", "-c", "96", "--max-tokens", "10",
            "--batch", "2", "--prefill-bucket", "16", "--decode-chunk", "8",
            "--prompts", str(pfile), "--device", "cpu"]
    fuse_env("0")
    plain = _serve_records(serve, argv, capsys)
    fuse_env("1")
    assert serve(argv) == 0
    out, err = capsys.readouterr()
    assert "fuse=1" in err
    assert [{k: r[k] for k in ("id", "prompt", "text", "n_tokens")}
            for r in map(json.loads, out.splitlines())] == plain


def test_cli_still_refuses_what_is_not_ported(ckpt, capsys):
    """--tp and --coordinator run since they were ported
    (tests/test_torch_multihost.py); what the CLI still refuses: a
    --coordinator flag without its two partners (rc 2), and Engine(tp > 1)
    outside a process group (one process a rank)."""
    base = [ckpt, "-m", "completion", "-i", "hi", "--device", "cpu"]
    for flag in (["--coordinator", "localhost:1234"], ["--num-processes", "2"],
                 ["--process-id", "0"]):
        assert cli(base + flag) == 2
    assert capsys.readouterr().err.count("go together") == 3
    with pytest.raises(RuntimeError, match="process group"):
        Engine(EngineConfig(path=ckpt, mode="pallas", tp=2, device="cpu"))


def test_fuse_is_read_as_the_jax_package_reads_it(monkeypatch):
    """Only "1" turns the fused matmuls on (qwen3_tpu's _make_fused_linear
    compares the variable to "1")."""
    assert fuse_from_env({"QWEN3_TPU_FUSE": "1"})
    for env in ({}, {"QWEN3_TPU_FUSE": "0"}, {"QWEN3_TPU_FUSE": "true"},
                {"QWEN3_TPU_FUSE": ""}):
        assert not fuse_from_env(env)
    monkeypatch.setenv("QWEN3_TPU_FUSE", "1")
    assert fuse_from_env()


def test_chat_runs_in_every_new_mode(ckpt, capsysbinary, monkeypatch):
    """A chat turn through the CLI in modes exact, bf16 and pallas-int8."""
    for qmode in ("exact", "bf16", "pallas-int8"):
        monkeypatch.setattr(sys, "stdin", io.StringIO("hi there\n\n"))
        assert cli([ckpt, "-m", "chat", "-t", "0", "-s", "3", "-c", "96",
                    "--qmode", qmode, "--device", "cpu"]) == 0
        assert b"[t/ms" in capsysbinary.readouterr().err
