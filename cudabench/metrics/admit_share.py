"""admit_share: the share of the window's wall time inside the program's
`admit` spans (BatchedEngine admitting queued requests: encoding, grouping,
prefill forwards and first tokens), in %."""

from cudabench.metrics import _spans

_spans.record_if_traced()


def read(run):
    sp, win = _spans.spans(), _spans.window_ns(run)
    if sp is None or win is None:
        return None
    lo, hi = win
    covered = sum(max(0.0, min(s.end, hi) - max(s.start, lo))
                  for s in sp if s.name == "admit" and s.end)
    return 100.0 * covered / (hi - lo)
