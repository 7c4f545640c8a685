"""queue_wait_ms_p50: the median, over the requests submitted in the
window, of the program's `queue` span: from its submit to the start of its
own admission (its batched group's or its serial prefill), in ms."""

import statistics

from cudabench.metrics import _spans

_spans.record_if_traced()


def read(run):
    sp = _spans.spans()
    if sp is None or _spans.window_ns(run) is None:
        return None
    queue = {s.rid: s for s in sp if s.name == "queue"}
    waits = [(queue[r.req.rid].end - queue[r.req.rid].start) / 1e6
             for r in run.window_records() if r.req.rid in queue]
    return statistics.median(waits) if waits else None
