"""matmul_roofline: the matmul kernels' share of their roofline in the
traced sub-window: the least time the card needs for the sub-window's
matmul work over the kernels' device time. The kernels' names and the
work are the model's family "matmul" (models/<model>.py), so that a
kernel that renames itself is added there as data."""

from cudabench.metrics import _roofline as rl


def read(run):
    return rl.share(run, "matmul")
