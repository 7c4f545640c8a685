"""prefill_rows_per_forward: the prompt tokens the window's prefill
forwards computed over those forwards (runtime/batched.py's counters
prefill_valid_rows and prefill_forwards): how many requests' rows an
admission puts into one forward."""

from cudabench.metrics import _spans

_spans.record_if_traced()


def read(run):
    c = _spans.window_counts(run)
    if c is None or c["prefill_forwards"] <= 0:
        return None
    return c["prefill_valid_rows"] / c["prefill_forwards"]
