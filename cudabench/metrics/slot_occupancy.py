"""slot_occupancy: tokens generated in the window over the slot-steps the
engine ran (decode steps, models/qwen3.py's CALLS, times the slots): the
slot-steps lost to slots left empty or frozen after they finish inside a
chunk."""


def read(run):
    loop = run.loop
    if loop.b_end is None or loop.b_end <= loop.b0:
        return None
    steps = loop.b_end - loop.b0
    return (100.0 * run.tokens(loop.b0, loop.b_end)
            / (steps * int(run.engine["max_batch"])))
