"""frozen_slot_share: the share of the window's slot-steps (decode steps x
slots, runtime/batched.py's slot_steps_* counters) that ran a slot whose
request had finished earlier in its chunk, in %: the part of the
slot-steps slot_occupancy loses to chunk granularity, not to empty
slots."""

from cudabench.metrics import _spans

_spans.record_if_traced()


def read(run):
    c = _spans.window_counts(run)
    if c is None:
        return None
    total = (c["slot_steps_live"] + c["slot_steps_frozen"]
             + c["slot_steps_empty"])
    return 100.0 * c["slot_steps_frozen"] / total if total else None
