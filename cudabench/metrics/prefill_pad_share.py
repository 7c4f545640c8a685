"""prefill_pad_share: the share of the rows the window's prefill forwards
computed that held no prompt token (runtime/batched.py's counters
prefill_rows and prefill_valid_rows: a block's padding past a prompt's
end), in %."""

from cudabench.metrics import _spans

_spans.record_if_traced()


def read(run):
    c = _spans.window_counts(run)
    if c is None or c["prefill_rows"] <= 0:
        return None
    return 100.0 * (c["prefill_rows"] - c["prefill_valid_rows"]) \
        / c["prefill_rows"]
