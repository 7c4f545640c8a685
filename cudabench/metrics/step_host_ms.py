"""step_host_ms: the median, over the program's `step` spans in the
window (one decode step of runtime/decode_loop.py::batched_decode_chunk),
of the step's host time outside its `step.read` (the wait for the card in
the host read of the sampled ids), in ms."""

import statistics

from cudabench.metrics import _spans

_spans.record_if_traced()


def read(run):
    sp, win = _spans.spans(), _spans.window_ns(run)
    if sp is None or win is None:
        return None
    steps = {i: s for i, s in enumerate(sp) if s.name == "step" and s.end
             and win[0] <= s.start and s.end <= win[1]}
    wait = dict.fromkeys(steps, 0)
    for s in sp:
        if s.name == "step.read" and s.parent in wait:
            wait[s.parent] += s.end - s.start
    host = [(s.end - s.start - wait[i]) / 1e6 for i, s in steps.items()]
    return statistics.median(host) if host else None
