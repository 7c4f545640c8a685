"""The expert layer's span and counters in a traced serve of preset
tiny-moe on the CPU (the kernels' plain versions): `moe` spans
(utils/profiling.py::SPANS) inside each decode `step` and each
`prefill.block`, `models/qwen3.py::CALLS["moe_layers"]` and
`["moe_rows"]` counting what ran, and the per-(layer, expert) counts of
the routing summing to the routed rows.

No JAX here: the checkpoint comes from the port's own IO."""

import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu_torch.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tq  # noqa: E402
from qwen3_tpu_torch.runtime import batched as B  # noqa: E402
from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request  # noqa: E402
from qwen3_tpu_torch.utils.profiling import SPANS  # noqa: E402

CFG = PRESETS["tiny-moe"]
PROMPTS = ["the cat", "in the hat and", "er on at", "the the the and er"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    SPANS.stop()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_spans") / "tiny-moe.bin")
    write_checkpoint(path, synthetic_weights(CFG, seed=21, scale=0.1))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(CFG.vocab_size))
    return path


def _serve(ckpt, spans: bool):
    eng = BatchedEngine(ckpt, max_batch=2, seq_len=96, mode="pallas-fast",
                        temperature=0.9, top_p=0.9, prefill_bucket=16,
                        decode_chunk=8, kv_dtype="int8", device="cpu")
    if spans:
        SPANS.start()
    reqs = [eng.submit(Request(prompt=p, seed=3 + i, max_tokens=6 + 2 * i))
            for i, p in enumerate(PROMPTS)]
    eng.run()
    return eng, reqs, SPANS.stop()


def _ancestors(spans, i):
    out = []
    while spans[i].parent is not None:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


def test_moe_spans_nest_under_the_steps_and_blocks(ckpt):
    before = dict(tq.CALLS)
    _, _, spans = _serve(ckpt, spans=True)
    passes = sum(tq.CALLS[k] - before[k]
                 for k in ("forward", "decode_forward", "forward_step"))
    moe = [i for i, s in enumerate(spans) if s.name == "moe"]
    assert len(moe) == CFG.n_layers * passes > 0
    under = [_ancestors(spans, i) for i in moe]
    assert all("step" in a or "prefill.block" in a for a in under)
    steps = sum(s.name == "step" for s in spans)
    assert sum("step" in a for a in under) == CFG.n_layers * steps > 0
    assert any("prefill.block" in a for a in under)
    assert all(spans[i].end >= spans[i].start > 0 for i in moe)


def test_moe_counters_count_what_ran(ckpt):
    before = dict(tq.CALLS)
    rows0 = B.COUNTS["prefill_rows"]
    eng, reqs, _ = _serve(ckpt, spans=False)
    d = {k: tq.CALLS[k] - before[k] for k in tq.CALLS}
    passes = d["forward"] + d["decode_forward"] + d["forward_step"]
    assert d["moe_layers"] == CFG.n_layers * passes
    # a decode step routes every slot, a prefill forward every row of its
    # block (padding rows too)
    rows = (B.COUNTS["prefill_rows"] - rows0 + 2 * d["decode_forward"])
    assert d["moe_rows"] == rows * CFG.n_experts_per_tok * CFG.n_layers
    counts = tq.expert_counts(eng.params)
    assert counts.shape == (CFG.n_layers, CFG.n_experts)
    assert int(counts.sum()) == d["moe_rows"]
    assert (counts.sum(-1) == d["moe_rows"] // CFG.n_layers).all()
    assert all(r.out_ids for r in reqs)


def test_tokens_equal_with_the_recorder_on_and_off(ckpt):
    off = [r.out_ids for r in _serve(ckpt, spans=False)[1]]
    on = [r.out_ids for r in _serve(ckpt, spans=True)[1]]
    assert on == off
