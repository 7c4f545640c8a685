"""idle_share: the share of the traced sub-window in which no operation
ran on the device (the union of its kernels, copies and sets)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s / tr.window_s)
