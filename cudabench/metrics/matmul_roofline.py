"""matmul_roofline: the matmul kernels' share of their roofline in the
traced sub-window: the least time the card needs for the sub-window's
matmul work (metrics/_roofline.py) over the kernels' device time. The
kernels are the port's Q8_0 matmuls of every mode, by name, so that a
kernel that renames itself is added here as data."""

from cudabench.metrics import _roofline as rl

KERNELS = ("q8_fast_tile_kernel", "q8_fast_split_kernel",
           "q8_fast_prologue_kernel", "q8q8_gemv_kernel", "q8q8_mma_kernel",
           "q8q8_split_sum_kernel", "q8q8_prologue_kernel",
           "q8i8_quantize_kernel", "q8i8_mma_kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    seconds = tr.seconds(KERNELS)
    if seconds <= 0:
        return None
    positions, admitted = rl.sub_window(run)
    flops, nbytes = rl.matmul_work(run.sizes, len(positions), tr.steps,
                                   sum(admitted), len(admitted),
                                   tr.forwards)
    return 100.0 * rl.least_seconds(flops, nbytes) / seconds
