"""The readers of the program's spans and counters (metrics/_spans.py and
the six metrics on it), the clocks' anchors and the split of the idle
gaps (core/spantrace.py), each on hand-built input, and a traced run of
the tiny stand-in cell that reads all six."""

import json
import statistics
import types
from pathlib import Path

import pytest

import tiny
from cudabench.core import spantrace, trace
from cudabench.metrics import _spans
from qwen3_tpu_torch.utils.profiling import SPANS

BENCH = Path(__file__).resolve().parents[1]
NEW = ("queue_wait_ms_p50", "admit_share", "prefill_rows_per_forward",
       "prefill_pad_share", "step_host_ms", "frozen_slot_share")
MS = 1_000_000          # ns


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    SPANS.stop()


def reader(name):
    from cudabench.core.spec import load_module
    return load_module(BENCH / "metrics" / f"{name}.py", f"test_{name}")


def counts(**kw):
    c = dict.fromkeys(("prefill_forwards", "prefill_rows",
                       "prefill_valid_rows", "admit_groups", "admitted",
                       "slot_steps_live", "slot_steps_frozen",
                       "slot_steps_empty"), 0)
    c.update(kw)
    return c


def hand_built():
    """A window of 1000 ms (t = 1000 to 2000 ms) over two chunks of 2
    steps and an admission of requests 5 and 6, and the run reading it."""
    SPANS.start()

    def span(name, a, b, **kw):
        sid = SPANS.begin(name, start=a * MS, **kw)
        return lambda: SPANS.end(sid, b * MS)

    SPANS.add("queue", 900 * MS, 1100 * MS, rid=5)
    SPANS.add("queue", 1050 * MS, 1100 * MS, rid=6)
    SPANS.add("queue", 100 * MS, 200 * MS, rid=1)       # before the window
    end = span("chunk", 600, 1010,
               counts=counts(prefill_forwards=3, prefill_rows=300,
                             prefill_valid_rows=200, slot_steps_live=10))
    end()
    end = span("admit", 1100, 1300)
    inner = span("admit.group", 1100, 1290, rid=(5, 6))
    span("prefill.block", 1100, 1200, rid=(5, 6))()
    span("prefill.block", 1200, 1280, rid=(5, 6))()
    inner()
    end()
    for a, b, c in ((1300, 1700, counts(prefill_forwards=4,
                                         prefill_rows=400,
                                         prefill_valid_rows=260,
                                         slot_steps_live=14,
                                         slot_steps_frozen=2)),
                    (1700, 2100, counts(prefill_forwards=5,
                                        prefill_rows=528,
                                        prefill_valid_rows=300,
                                        slot_steps_live=17,
                                        slot_steps_frozen=4,
                                        slot_steps_empty=1))):
        end = span("chunk", a, b, counts=c)
        for s in (a, a + 100):
            step = span("step", s, s + 100)
            span("step.enqueue", s, s + 30)()
            span("step.read", s + 30, s + 90 if s == a else s + 60)()
            step()
        end()
    loop = types.SimpleNamespace(t0=1.0, t_end=2.0, b0=10, b_end=14)
    recs = [types.SimpleNamespace(req=types.SimpleNamespace(rid=r))
            for r in (5, 6)]
    return types.SimpleNamespace(loop=loop, window_records=lambda: recs)


def test_each_reader_on_a_hand_built_run():
    run = hand_built()
    got = {name: reader(name).read(run) for name in NEW}
    assert got["queue_wait_ms_p50"] == pytest.approx(
        statistics.median([200, 50]))
    assert got["admit_share"] == pytest.approx(20.0)
    # the window's counters: the closing chunk's less the opening one's
    assert got["prefill_rows_per_forward"] == pytest.approx(100 / 2)
    assert got["prefill_pad_share"] == pytest.approx(100 * 128 / 228)
    assert got["frozen_slot_share"] == pytest.approx(100 * 4 / 12)
    # steps of 100 ms less their reads of 60 and 30 ms; the last chunk's
    # steps lie inside the window too
    assert got["step_host_ms"] == pytest.approx(statistics.median(
        [40, 70, 40, 70]))


def test_readers_read_nothing_without_spans(monkeypatch):
    run = hand_built()
    monkeypatch.setattr(spantrace, "recorder", lambda: None)
    monkeypatch.setattr(_spans, "recorder", lambda: None)
    assert all(reader(name).read(run) is None for name in NEW)
    SPANS.stop()
    monkeypatch.undo()
    assert all(reader(name).read(run) is None for name in NEW)


def test_the_recorder_starts_only_in_a_traced_run():
    assert _spans.traced(["run.py", "--workload", "x", "--trace", "1"])
    assert _spans.traced(["--trace=1"])
    assert not _spans.traced(["--trace", "0"]) and not _spans.traced([])
    assert not _spans.traced(["--trace"])
    _spans.record_if_traced(["--trace", "0"])
    assert not SPANS.on
    _spans.record_if_traced(["--trace", "1"])
    assert SPANS.on


def synthetic_trace(tmp_path):
    """Four kernels with three idle gaps between them: one under a program
    span, one in a runtime call, one under neither; and the two clock
    anchors' synchronizes, the trace's clock 5 ms ahead of perf_counter."""
    off_us = 5000.0
    ev = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": t, "dur": 10}
          for i, t in enumerate((0, 20, 40, 60))]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": t, "dur": d}
           for n, t, d in (("cudaDeviceSynchronize", -5, 2),
                           ("cudaLaunchKernel", 31, 8),
                           ("cudaMemcpyAsync", 71, 2),
                           ("cudaDeviceSynchronize", 80, 2),
                           ("cudaDeviceSynchronize", 84, 1))]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # host reads around each anchor's one synchronize, in perf_counter ns
    # (the trace's last synchronize is core/trace.py's own, at the stop)
    reads = [[((-5 - off_us) * 1e3 - 500, (-3 - off_us) * 1e3 + 500)],
             [((80 - off_us) * 1e3 - 700, (82 - off_us) * 1e3 + 700)]]
    SPANS.start()

    def span(name, a, b):
        sid = SPANS.begin(name, start=int((a - off_us) * 1e3))
        return lambda: SPANS.end(sid, int((b - off_us) * 1e3))

    chunk = span("chunk", 1, 79)
    step = span("step", 1, 69)
    span("step.enqueue", 1, 19)()
    span("step.read", 70, 74)()
    step()
    chunk()
    SPANS.add("queue", int((-100 - off_us) * 1e3), int((100 - off_us) * 1e3))
    return str(path), reads, SPANS.stop()


def test_the_python_gaps_split_by_span(tmp_path):
    path, reads, spans = synthetic_trace(tmp_path)
    ops, busy, top_ops, idle = trace.read(path)
    assert dict(idle) == pytest.approx({"(python)": 20e-6,
                                        "cudaLaunchKernel": 10e-6})
    dev, host = spantrace.events_of(
        json.loads(Path(path).read_text())["traceEvents"])
    pairs = spantrace.anchors(host, reads)
    assert [(o, u) for _, o, u in pairs] == pytest.approx(
        [(5e6, 1000), (5e6, 1400)])
    to_us = spantrace.clock(pairs)
    split = spantrace.split_idle(dev, host, spans, to_us, idle)
    # the gap at 10-20 us lies in step.enqueue's end and step's rest: its
    # middle, 15 us, in step.enqueue; the gap at 50-60 us in step alone
    assert dict(split) == pytest.approx({"(python) step.enqueue": 10e-6,
                                         "(python) step": 10e-6,
                                         "cudaLaunchKernel": 10e-6})
    assert sum(s for n, s in split if n.startswith("(python)")) == \
        pytest.approx(dict(idle)["(python)"])
    # the step.read span (70-74 us once mapped) holds the memcpy at 71-73
    assert spantrace.reads_held(host, spans, to_us, (-5, 82)) == (1, 1)
    assert spantrace.reads_held(host, spans, lambda t: to_us(t) + 3,
                                (-5, 82)) == (0, 1)


def test_a_gap_under_no_span_stays_python(tmp_path):
    path, reads, spans = synthetic_trace(tmp_path)
    _, _, _, idle = trace.read(path)
    dev, host = spantrace.events_of(
        json.loads(Path(path).read_text())["traceEvents"])
    # a clock that puts every span far from the trace
    split = spantrace.split_idle(dev, host, spans, lambda t: t / 1e3 + 1e6,
                                 idle)
    assert dict(split) == pytest.approx(dict(idle))


def test_a_traced_tiny_run_reads_the_six(tmp_path, monkeypatch):
    from test_cudabench_runs import run_cell

    root = tiny.make_root(tmp_path)
    monkeypatch.setattr("sys.argv", ["run.py", "--trace", "1"])
    rc, res = run_cell(root, trace=1, seconds=6)
    assert rc == 0 and res["correct"] is True, res["checks"]
    for name in NEW:
        assert name in res["metrics"], name
    m = {n: res["metrics"][n]["value"] for n in NEW}
    assert m["queue_wait_ms_p50"] > 0 and m["step_host_ms"] > 0
    assert 0 < m["admit_share"] < 100
    assert m["prefill_rows_per_forward"] >= 8      # the mix's least prompt
    assert 0 <= m["prefill_pad_share"] < 100
    assert 0 <= m["frozen_slot_share"] < 100
    for name in ("slot_occupancy", "ttft_p95_ms", "prefill_ms_p50"):
        assert res["metrics"][name]["value"] > 0


def test_an_untraced_tiny_run_records_no_span(tmp_path, monkeypatch):
    from test_cudabench_runs import run_cell

    root = tiny.make_root(tmp_path)
    monkeypatch.setattr("sys.argv", ["run.py", "--trace", "0"])
    rc, res = run_cell(root, trace=0, seconds=2)
    assert rc == 0 and not SPANS.on and SPANS.spans() == []


def test_the_clock_follows_two_anchors_apart_in_rate():
    # the trace's clock runs 100 ppm fast of perf_counter, 5 ms ahead at 0;
    # each anchor of two synchronizes whose reads bound the offset from
    # either side, to within 0.2 us
    def sync(t_us, d_us):
        return (5000 + t_us * 1.0001, d_us, "cudaDeviceSynchronize")

    host = [sync(0, 2), sync(10, 2), (5000 + 5e6, 5, "cudaLaunchKernel"),
            sync(10e6, 2), sync(10e6 + 10, 2), sync(10e6 + 20, 1)]
    reads = [[(-100, 2100), (10e3 - 1900, 10e3 + 2100)],
             [(10e9 - 100, 10e9 + 3100), (10e9 + 10e3 - 1900,
                                           10e9 + 10e3 + 2100)]]
    pairs = spantrace.anchors(host, reads)
    assert [o / 1e6 for _, o, _ in pairs] == pytest.approx(
        [5.0, 6.0], abs=2e-4)
    assert all(0 <= u <= 200.1 for _, _, u in pairs)
    to_us = spantrace.clock(pairs)
    assert to_us(5e9) == pytest.approx(5000 + 5e6 * 1.0001, abs=0.5)
