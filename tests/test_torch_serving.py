"""The port's continuous-batching server (qwen3_tpu_torch/runtime/batched.py
BatchedEngine and serve.py) against the JAX package's on the `tiny`
synthetic checkpoint, on the CPU (the kernels' plain versions against the
Pallas kernels in interpret mode): per-request prompt_ids + out_ids equal in
modes pallas and pallas-fast, attention fused (the "auto" resolution),
dense and flash (the two-segment kernel), side buffer on and off, greedy
and seeded (t 0.9), int8 and f32 KV.

The requests below are ones without a rounding flip between the packages.
The two packages' fp32 ops differ in the last ulp, and where a value sits
within an ulp of a rounding boundary it moves by a whole step (ROADMAP.md,
Queue C): a Q8 activation or int8 K/V value in both modes, and under
pallas-fast also a bf16 rounding of an activation before a matmul or of the
attention's value-dot operand, which happens far more often (four
activations a layer, every token). On this checkpoint "and er" with seed 32
has one under pallas-fast, fused, int8 KV, t 0.9, and some seeded stream
then picks another token; so do other prompts and seeds in other cells.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.runtime.batched import BatchedEngine as JaxEngine  # noqa: E402
from qwen3_tpu.runtime.batched import Request as JaxRequest  # noqa: E402
from qwen3_tpu.serve import main as jax_serve  # noqa: E402
from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request  # noqa: E402
from qwen3_tpu_torch.serve import main as serve  # noqa: E402

# (prompt, seed): four requests for three slots, so one waits for a slot
REQUESTS = [("in the hat and", 30), ("the the the", 31),
            ("on at the the", 33), ("the cat", 34)]


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
    d = tmp_path_factory.mktemp("torch_serving")
    path = str(d / "tiny.bin")
    write_checkpoint(path, tiny_weights)
    write_tokenizer_bin(path + ".tokenizer", tiny_tok)
    return path


def _streams(make, request, ckpt, mode, attn, kv_dtype, temperature, side):
    eng = make(ckpt, max_batch=3, seq_len=96, mode=mode,
               temperature=temperature, top_p=0.9, prefill_bucket=16,
               decode_chunk=8, kv_dtype=kv_dtype, attn=attn,
               side_buffer=side)
    reqs = [eng.submit(request(prompt=p, seed=s, max_tokens=12))
            for p, s in REQUESTS]
    done = eng.run()
    assert len(done) == len(REQUESTS) and all(r.finished for r in reqs)
    return eng.attn, [r.prompt_ids + r.out_ids for r in reqs]


@pytest.mark.parametrize(
    "mode,attn,kv_dtype,temperature,side",
    [("pallas-fast", "auto", "int8", 0.0, True),
     ("pallas-fast", "auto", "int8", 0.9, True),
     ("pallas-fast", "auto", "float32", 0.9, True),
     ("pallas", "auto", "int8", 0.9, True),
     ("pallas", "auto", "float32", 0.0, True),
     ("pallas-fast", "dense", "int8", 0.9, True),
     ("pallas-fast", "dense", "float32", 0.0, False),
     ("pallas", "dense", "int8", 0.9, False),
     ("pallas-fast", "flash", "int8", 0.9, True),
     ("pallas", "flash", "float32", 0.0, True),
     ("pallas-fast", "flash", "int8", 0.0, False),
     ("pallas", "flash", "int8", 0.9, False),
     ("exact", "auto", "int8", 0.9, True),
     ("bf16", "auto", "float32", 0.0, True)])
def test_engine_streams_match_jax(ckpt, mode, attn, kv_dtype, temperature,
                                  side):
    """"auto" resolves to fused (three slots, side buffer, a pallas mode),
    in both packages, and to dense in modes exact and bf16; flash with the
    side buffer runs the two-segment kernel, without it flash decode."""
    want_attn, want = _streams(JaxEngine, JaxRequest, ckpt, mode, attn,
                               kv_dtype, temperature, side)
    got_attn, got = _streams(
        lambda *a, **kw: BatchedEngine(*a, device="cpu", **kw), Request,
        ckpt, mode, attn, kv_dtype, temperature, side)
    auto = "fused" if mode.startswith("pallas") else "dense"
    assert got_attn == want_attn == (auto if attn == "auto" else attn)
    assert got == want


def test_library_defaults_match_jax():
    """The engines' library defaults are the JAX package's: every
    EngineConfig field and every BatchedEngine keyword the two share (mode
    "bf16" among them); the port's own knobs (device, fuse,
    native_tokenizer) are the only ones the JAX side lacks."""
    import dataclasses
    import inspect

    from qwen3_tpu.runtime.engine import EngineConfig as JaxConfig
    from qwen3_tpu_torch.runtime.engine import EngineConfig

    own = {"device", "fuse", "native_tokenizer"}
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert set(fields) - set(jax_fields) == own
    assert {k: fields[k] for k in fields.keys() & jax_fields.keys()} == {
        k: jax_fields[k] for k in fields.keys() & jax_fields.keys()}
    assert fields["mode"] == "bf16"

    def defaults(cls):
        return {k: p.default for k, p in
                inspect.signature(cls.__init__).parameters.items()}

    jax_kw, kw = defaults(JaxEngine), defaults(BatchedEngine)
    assert set(kw) - set(jax_kw) == own
    assert {k: kw[k] for k in jax_kw} == jax_kw
    assert kw["mode"] == "bf16"


def _serve_records(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return [{k: r[k] for k in ("id", "prompt", "text", "n_tokens")}
            for r in map(json.loads, out.splitlines())]


@pytest.mark.parametrize("temperature,prompts", [
    ("0.9", ["in the hat and", "the the the"]),
    ("0", [p for p, _ in REQUESTS])])
def test_serve_prints_jax_serves_records(ckpt, tmp_path, capsys,
                                         temperature, prompts):
    """serve.py with the JAX serve's flags and defaults (pallas-fast, int8,
    auto -> fused) prints the same JSON records (timing fields aside), in
    the same completion order, as python -m qwen3_tpu.serve; seeded, the
    seed of line i is -s + i (30 and 31 here, flip-free above)."""
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("\n".join(prompts) + "\n")
    argv = [ckpt, "-t", temperature, "-s", "30", "-c", "96",
            "--max-tokens", "12", "--batch", "3", "--prefill-bucket", "16",
            "--decode-chunk", "8", "--prompts", str(pfile)]
    want = _serve_records(jax_serve, argv, capsys)
    got = _serve_records(serve, argv + ["--device", "cpu"], capsys)
    assert len(got) == len(prompts)
    assert got == want


def test_serve_refuses_what_is_not_ported(ckpt, tmp_path, capsys):
    """--aot-dir and the card without one are refused; --qmode bf16
    (refused before it was ported) runs, and so do --tp/--dp (ported later:
    tests/test_torch_multihost.py runs them)."""
    pfile = tmp_path / "p.txt"
    pfile.write_text("the cat\n")
    base = [ckpt, "--prompts", str(pfile), "--device", "cpu"]
    assert serve(base + ["--qmode", "bf16", "-c", "64", "--max-tokens",
                         "4"]) == 0
    (rec,) = map(json.loads, capsys.readouterr().out.splitlines())
    assert rec["prompt"] == "the cat" and 0 <= rec["n_tokens"] <= 4
    with pytest.raises(NotImplementedError, match="not ported"):
        serve(base + ["--aot-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve([ckpt, "--prompts", str(pfile)])
