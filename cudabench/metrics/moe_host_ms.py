"""moe_host_ms: the median, over the program's `step` spans in the window
(one decode step), of the host time inside the `moe` spans under each
(models/qwen3.py::_moe: the enqueue of one expert layer), in ms. A program
without the span reads nothing."""

import statistics

from cudabench.metrics import _spans

_spans.record_if_traced()


def _step_of(sp, i):
    """The `step` span that span i runs inside, or None."""
    while sp[i].parent is not None:
        i = sp[i].parent
        if sp[i].name == "step":
            return i
    return None


def read(run):
    sp, win = _spans.spans(), _spans.window_ns(run)
    if sp is None or win is None:
        return None
    steps = {i: 0 for i, s in enumerate(sp) if s.name == "step" and s.end
             and win[0] <= s.start and s.end <= win[1]}
    for i, s in enumerate(sp):
        if s.name == "moe" and s.end:
            step = _step_of(sp, i)
            if step in steps:
                steps[step] += s.end - s.start
    host = [t / 1e6 for t in steps.values() if t > 0]
    return statistics.median(host) if host else None
