"""The serving engine's spans and counters (utils/profiling.py::SPANS,
runtime/batched.py::COUNTS), on the CPU (the kernels' plain versions): the
span tree and the request ids it carries, the counters' identities, the
tokens with the recorder on and off, what the recorder costs while off,
the spans in profile_trace's Chrome trace, and the collectives' span.

No JAX here: the checkpoint comes from the port's own IO."""

import json
import tracemalloc
from pathlib import Path

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
from qwen3_tpu_torch.utils import profiling  # noqa: E402
from qwen3_tpu_torch.utils.profiling import SPANS  # noqa: E402

# prompt lengths over one and two prefill blocks at bucket 16: some share a
# block plan (one batched group), some do not (serial admissions)
PROMPTS = ["the cat", "in the hat and", "er on at", "the the the",
           " ".join(["the cat in a hat er on at"] * 3) + " 1",
           " ".join(["the cat in a hat er on at"] * 3) + " 22", "and er"]
MAX_BATCH = 3
NAMES = {"queue", "admit", "admit.encode", "admit.group", "prefill.block",
         "first_tokens", "chunk", "step", "step.enqueue", "step.read",
         "chunk.merge", "chunk.deliver"}


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
    cfg = PRESETS["tiny"]
    path = str(tmp_path_factory.mktemp("spans") / "tiny.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=1234))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


def _serve(ckpt, temperature=0.9, spans=False, side=True):
    """Every prompt through a 3-slot engine, some requests finishing
    inside a chunk; returns (the requests, the spans recorded)."""
    eng = BatchedEngine(ckpt, max_batch=MAX_BATCH, seq_len=96,
                        mode="pallas-fast", temperature=temperature,
                        top_p=0.9, prefill_bucket=16, decode_chunk=8,
                        kv_dtype="int8", device="cpu", side_buffer=side)
    if spans:
        SPANS.start()
    reqs = [eng.submit(Request(prompt=p, seed=40 + i, max_tokens=5 + 3 * i))
            for i, p in enumerate(PROMPTS)]
    eng.run()
    return reqs, SPANS.stop()


def _rids(span):
    return span.rid if isinstance(span.rid, tuple) else (span.rid,)


def test_span_tree_nests_and_requests_share_their_ids(ckpt):
    reqs, spans = _serve(ckpt, spans=True)
    assert {s.name for s in spans} == NAMES
    for s in spans:
        assert 0 < s.start <= s.end, s
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
    parent = {s.name: set() for s in spans}
    for s in spans:
        parent[s.name].add(None if s.parent is None
                           else spans[s.parent].name)
    assert parent == {
        "queue": {None}, "admit": {None}, "chunk": {None},
        "admit.encode": {"admit"}, "admit.group": {"admit"},
        "prefill.block": {"admit.group"}, "first_tokens": {"admit.group"},
        "step": {"chunk"}, "step.enqueue": {"step"}, "step.read": {"step"},
        "chunk.merge": {"chunk"}, "chunk.deliver": {"chunk"}}
    groups = [s for s in spans if s.name == "admit.group"]
    assert any(len(_rids(g)) > 1 for g in groups)     # a batched group
    assert any(isinstance(g.rid, int) for g in groups)  # a serial one
    for r in reqs:
        [queue] = [s for s in spans if s.name == "queue" and s.rid == r.rid]
        [group] = [g for g in groups if r.rid in _rids(g)]
        assert queue.end == group.start
        gi = spans.index(group)
        blocks = [s for s in spans if s.name == "prefill.block"
                  and s.parent == gi]
        assert blocks and all(s.rid == group.rid for s in blocks)
        assert abs(r.prompt_ms - (group.end - group.start) / 1e6) < 1e-9
    # one admit per _admit call that admitted anything, one chunk a _step
    for a in (s for s in spans if s.name == "admit"):
        assert any(spans[c.parent] is a for c in spans
                   if c.name == "admit.group" and c.parent is not None)


def test_counters_add_up(ckpt, monkeypatch):
    rows = []
    orig_b, orig_s = B.prefill_slots_chunk, B.prefill_slot_chunk

    def count_b(params, cfg, k, v, tokens, *a, **kw):
        rows.append(len(tokens) * len(tokens[0]))
        return orig_b(params, cfg, k, v, tokens, *a, **kw)

    def count_s(params, cfg, k, v, tokens, *a, **kw):
        rows.append(len(tokens))
        return orig_s(params, cfg, k, v, tokens, *a, **kw)

    monkeypatch.setattr(B, "prefill_slots_chunk", count_b)
    monkeypatch.setattr(B, "prefill_slot_chunk", count_s)
    before, steps0 = dict(B.COUNTS), tq.CALLS["decode_forward"]
    reqs, spans = _serve(ckpt, spans=True)
    got = {k: B.COUNTS[k] - before[k] for k in B.COUNTS}
    steps = tq.CALLS["decode_forward"] - steps0
    assert (got["slot_steps_live"] + got["slot_steps_frozen"]
            + got["slot_steps_empty"]) == steps * MAX_BATCH
    assert got["slot_steps_frozen"] > 0 and got["slot_steps_empty"] > 0
    assert got["prefill_forwards"] == len(rows) == sum(
        s.name == "prefill.block" for s in spans)
    assert got["prefill_rows"] == sum(rows)
    assert got["prefill_valid_rows"] == sum(len(r.prompt_ids) for r in reqs)
    assert got["prefill_rows"] > got["prefill_valid_rows"]      # padding
    assert got["admitted"] == len(reqs)
    assert got["admit_groups"] == sum(s.name == "admit.group" for s in spans)
    # every chunk span keeps the counters as they stood at its end
    last = [s for s in spans if s.name == "chunk"][-1]
    assert last.counts == B.COUNTS


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_tokens_equal_with_the_recorder_on_and_off(ckpt, temperature):
    off, _ = _serve(ckpt, temperature)
    on, spans = _serve(ckpt, temperature, spans=True)
    assert spans
    assert ([r.prompt_ids + r.out_ids for r in on]
            == [r.prompt_ids + r.out_ids for r in off])


def test_off_stores_nothing_and_reads_no_clock(ckpt, monkeypatch):
    def no_clock():
        raise AssertionError("the span clock was read while off")

    monkeypatch.setattr(SPANS, "clock", no_clock)
    reqs, spans = _serve(ckpt)
    assert spans == [] and SPANS._open == []
    assert all(r.finished and r._t_submit == 0 for r in reqs)


def test_off_keeps_nothing():
    """Off, a thousand steps' spans keep no memory: `begin` returns None
    and `end(None)` returns, with no object made on the way."""
    def steps():
        for _ in range(1000):
            sid = SPANS.begin("step", rid=7)
            read = SPANS.begin("step.read")
            SPANS.end(read)
            SPANS.end(sid)

    steps()
    tracemalloc.start()
    try:
        steps()
        before = tracemalloc.get_traced_memory()[0]
        steps()
        current = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert current == before
    assert SPANS.spans() == []


def test_an_exception_ends_the_spans_it_leaves():
    SPANS.start()
    outer = SPANS.begin("chunk")
    SPANS.begin("chunk.deliver")          # left by the exception
    SPANS.end(outer)
    SPANS.end(outer)                      # a second end changes nothing
    spans = SPANS.stop()
    assert [s.end for s in spans] == [spans[0].end] * 2 and spans[0].end
    assert SPANS._open == []


def test_profile_trace_carries_the_spans(ckpt, tmp_path):
    eng = BatchedEngine(ckpt, max_batch=2, seq_len=64, mode="pallas-fast",
                        temperature=0.0, prefill_bucket=16, decode_chunk=4,
                        kv_dtype="int8", device="cpu")
    with profiling.profile_trace(str(tmp_path), device="cpu") as path:
        for p in PROMPTS[:3]:
            eng.submit(Request(prompt=p, seed=1, max_tokens=6))
        eng.run()
    assert not SPANS.on
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert {e["name"] for e in spans} >= {"queue", "admit.group",
                                          "prefill.block", "step"}
    assert {e["tid"] for e in spans if e["name"] == "queue"} == {2}
    assert {e["tid"] for e in spans if e["name"] != "queue"} == {1}
    # on the trace's clock: every prefill forward's span holds host ops
    for blk in (e for e in spans if e["name"] == "prefill.block"):
        assert any(blk["ts"] <= o["ts"]
                   and o["ts"] + o["dur"] <= blk["ts"] + blk["dur"]
                   for o in ops), blk


def test_collectives_are_spans_and_counted():
    import torch.distributed as dist

    from qwen3_tpu_torch.parallel import comm, launch

    assert set(comm.COUNTS) == {"calls", "bytes"}
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            f"{launch.free_port()}", world_size=1, rank=0)
    try:
        group = comm.Group([0], dist.group.WORLD, "gloo")
        before = dict(comm.COUNTS)
        SPANS.start()
        out = group.sum(torch.ones(4))
        group.broadcast(torch.ones(2), 0)
        spans = SPANS.stop()
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, torch.ones(4))
    assert [s.name for s in spans] == ["collective"] * 2
    assert comm.COUNTS["calls"] - before["calls"] == 2
    assert comm.COUNTS["bytes"] - before["bytes"] == 4 * 4 + 2 * 4
