"""The perplexity eval and the quality table of the PyTorch port
(qwen3_tpu_torch/eval, qwen3_tpu_torch/tools/quality_table.py) against the
JAX package's on the `tiny` synthetic checkpoint, on the CPU: per-position
NLLs in every mode within 1e-5, the evaluator CLI's JSON line, and the
quality table's JSON keys, rows and gate, with each ppl within 1e-5
relative.

The evaluation texts are the quality table's own deterministic
pseudo-text, at seeds chosen so that the two packages' logits agree to an
ulp-level gap (no Q8 or bf16 rounding flip between them, ROADMAP.md Queue C
#1) and the NLLs agree far inside the tolerance. Mode bf16 rounds every
activation to bf16 before every matmul, and most texts meet a flip there
(seeds 7 and 9-18 at 48 tokens; the NLLs then move by up to 6e-4); seed 19
has none."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.eval.__main__ import main as jax_eval  # noqa: E402
from qwen3_tpu.eval.perplexity import sequence_nll as jax_nll  # noqa: E402
from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.models.qwen3 import init_params  # noqa: E402
from qwen3_tpu.tools.quality_table import main as jax_table  # noqa: E402
from qwen3_tpu_torch.eval.__main__ import main as port_eval  # noqa: E402
from qwen3_tpu_torch.eval.perplexity import sequence_nll  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tq  # noqa: E402
from qwen3_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from qwen3_tpu_torch.tools.quality_table import (  # noqa: E402
    main as port_table,
    pseudo_text,
)

CTX = 64


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
    d = tmp_path_factory.mktemp("torch_eval")
    path = str(d / "tiny.bin")
    write_checkpoint(path, tiny_weights)
    write_tokenizer_bin(path + ".tokenizer", tiny_tok)
    return path


@pytest.mark.parametrize("mode,kv_dtype", [
    ("exact", "float32"), ("bf16", "float32"), ("pallas", "float32"),
    ("pallas-fast", "float32"), ("pallas-int8", "float32"),
    ("pallas", "int8")])
def test_sequence_nll_matches_jax(ckpt, tiny_weights, mode, kv_dtype):
    """48 tokens in 16-token chunks (the last chunk shorter than the
    others), the cache carried across chunks."""
    cfg = tiny_weights.config
    seed = 19 if mode == "bf16" else 7
    ids = Tokenizer.from_file(ckpt).encode(pseudo_text(400, seed))[:48]
    assert len(ids) == 48
    jp = init_params(tiny_weights, mode=mode, max_seq_len=CTX)
    want = jax_nll(jp, cfg, ids, mode=mode, kv_dtype=jnp.dtype(kv_dtype),
                   chunk=16)
    tp = tq.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    got = sequence_nll(tp, cfg, ids, mode=mode, kv_dtype=kv_dtype, chunk=16)
    assert got.shape == want.shape == (47,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eval_cli_prints_the_jax_line(ckpt, tmp_path, capsys):
    text = tmp_path / "text.txt"
    text.write_text(pseudo_text(300))
    argv = [ckpt, "--text", str(text), "--qmode", "pallas", "-c", str(CTX)]
    assert jax_eval(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_eval(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["tokens"] == want["tokens"]
    assert got["nll"] == pytest.approx(want["nll"], abs=2e-6)
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-5)


def test_quality_table_matches_jax(ckpt, tmp_path, capsys):
    """The default modes (exact, pallas, pallas-fast, bf16) and the
    pallas+int8kv row at -c 64: the same JSON keys, rows and gate; each ppl
    within 1e-5 relative. Then pallas-int8 alone against exact. The text is
    pseudo-text at seed 34, flip-free in all six runs (the default seed 7
    meets bf16 flips at 64 tokens)."""
    text = tmp_path / "text.txt"
    text.write_text(pseudo_text(8 * CTX, 34))
    argv = [ckpt, "-c", str(CTX), "--text", str(text)]
    rc = jax_table(argv)
    want = json.loads(capsys.readouterr().out)
    assert port_table(argv + ["--device", "cpu"]) == rc
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    assert (got["metric"], got["ctx"], got["tokens"], got["pass"]) == (
        want["metric"], want["ctx"], want["tokens"], want["pass"])
    assert list(got["rows"]) == list(want["rows"]) == [
        "exact", "pallas", "pallas-fast", "bf16", "pallas+int8kv"]
    for label, row in want["rows"].items():
        assert got["rows"][label]["ppl"] == pytest.approx(row["ppl"],
                                                          rel=1e-5)
    argv = [ckpt, "-c", str(CTX), "--text", str(text), "--modes",
            "exact,pallas-int8", "--no-int8-kv"]
    rc = jax_table(argv)
    want = json.loads(capsys.readouterr().out)
    assert port_table(argv + ["--device", "cpu"]) == rc
    got = json.loads(capsys.readouterr().out)
    assert list(got["rows"]) == ["exact", "pallas-int8"]
    assert got["pass"] == want["pass"]
    assert got["rows"]["pallas-int8"]["ppl"] == pytest.approx(
        want["rows"]["pallas-int8"]["ppl"], rel=1e-5)
