"""route_roofline: the expert layer's routing kernels' (router with its
selection, the per-expert index, the weighted combine) share of their
roofline in the traced sub-window. The kernels and the work are the
model's family "routing" (models/<model>.py)."""

from cudabench.metrics import _roofline as rl


def read(run):
    return rl.share(run, "routing")
