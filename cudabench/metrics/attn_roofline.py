"""attn_roofline: decode attention's share of its roofline in the traced
sub-window: the least time for every generated token's attention over its
own depth (metrics/_roofline.py) over the device time of the batched
decode kernel (ops/cuda/batched_decode.py, csrc/decode_partial.cuh)."""

from cudabench.metrics import _roofline as rl

KERNELS = ("decode_kernel",)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    seconds = tr.seconds(KERNELS)
    positions, _ = rl.sub_window(run)
    if seconds <= 0 or not positions:
        return None
    flops, nbytes = rl.decode_attention_work(run.sizes, positions)
    return 100.0 * rl.least_seconds(flops, nbytes) / seconds
