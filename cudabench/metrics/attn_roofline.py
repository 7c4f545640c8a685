"""attn_roofline: decode attention's share of its roofline in the traced
sub-window: the least time for every generated token's attention over its
own depth over the device time of the model's family "attention"
(models/<model>.py: the batched decode kernel of ops/cuda/batched_decode.py,
csrc/decode_partial.cuh)."""

from cudabench.metrics import _roofline as rl


def read(run):
    return rl.share(run, "attention")
