"""The peaks of the card, and what the rooflines and the step's MFU share.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
(no sparsity) at its 700 W limit: 989 TFLOP/s in bf16 (pallas-fast
multiplies bf16 activations by bf16-dequantized weights), 3.35 TB/s of
HBM3. A share is the least time the card could take (the larger of the
operations over the FLOP peak and the bytes over the byte peak) over the
time measured, so it reads the same work whatever kernel does it.

The work itself is the model's: a configuration's model module
(models/<model>.py, `run.model`) gives each of its kernel families as a
`Family` under FAMILIES, by the family's name.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

PEAK_FLOPS = 989e12      # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12     # HBM3, H100 SXM


class Family(NamedTuple):
    """One kernel family of a model: the short names of its kernels; the
    (operations, bytes) they need for a traced sub-window,
    `work(sizes, positions, admitted, steps, forwards)`; and the
    operations of the measured window that the step's MFU sums,
    `flops(sizes, positions, admitted)`. `positions` are the cache
    positions of the generated tokens, `admitted` the prompt lengths of
    the requests admitted, `steps` and `forwards` the decode steps and
    prefill block forwards."""
    kernels: tuple[str, ...]
    work: Callable[..., tuple[float, float]]
    flops: Callable[..., float]


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def sub_window(run):
    """(generated positions, admitted prompt lengths) of the traced
    sub-window."""
    lo, hi = run.trace.bursts
    return run.positions(lo, hi), run.admitted(lo, hi)


def share(run, family: str) -> float | None:
    """The model's `family` kernels' share of their roofline in the traced
    sub-window, in %: the least time for its work over the kernels' device
    time; None where the model has no such family, the kernels did not
    run or the sub-window holds none of its work."""
    tr, fam = run.trace, run.model.FAMILIES.get(family)
    if tr is None or fam is None:
        return None
    seconds = tr.seconds(fam.kernels)
    if seconds <= 0:
        return None
    positions, admitted = sub_window(run)
    flops, nbytes = fam.work(run.sizes, positions, admitted, tr.steps,
                             tr.forwards)
    if flops <= 0 and nbytes <= 0:
        return None
    return 100.0 * least_seconds(flops, nbytes) / seconds
