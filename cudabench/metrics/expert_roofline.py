"""expert_roofline: the sparse expert layer's grouped Q8_0 kernels' share
of their roofline in the traced sub-window: the least time the card needs
for the sub-window's expert work (every expert's weights once a decode
step and a prefill forward, and its pairs' FMAs) over the kernels' device
time. The kernels and the work are the model's family "experts"
(models/<model>.py)."""

from cudabench.metrics import _roofline as rl


def read(run):
    return rl.share(run, "experts")
