"""Q8_0 activation quantization / dequantization as PyTorch ops.

Semantics match the reference runtime quantizer (src/q8.c:5-37): symmetric
per-group absmax scale `wmax/127` with a 1e-6 zero-guard, round half away from
zero (C roundf), clamp to [-127, 127].
"""

from __future__ import annotations

import functools

import torch

Q8_MAX = 127.0


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on `like`'s device. Dividing by it is a true
    IEEE division on every device; CUDA turns division by a Python scalar
    into a multiply by its reciprocal, which rounds differently. Made once
    per (value, device): a fresh one would be a blocking host-to-device copy
    that drains the stream at every call."""
    return _const(float(value), like.device)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even; the C engine uses roundf (half away).
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def quantize_act(x: torch.Tensor, group_size: int):
    """Quantize activations along the last axis in groups of `group_size`.

    Returns (q int8 [..., n], s fp32 [..., n // group_size]).
    """
    *lead, n = x.shape
    g = x.float().reshape(*lead, n // group_size, group_size)
    wmax = torch.amax(torch.abs(g), dim=-1)
    s = torch.where(wmax == 0.0, const(1e-6, g), wmax / const(Q8_MAX, g))
    q = round_half_away(g / s[..., None])
    q = torch.clamp(q, -Q8_MAX, Q8_MAX).to(torch.int8)
    return q.reshape(*lead, n), s


def dequantize(q: torch.Tensor, s: torch.Tensor, group_size: int,
               dtype=torch.float32) -> torch.Tensor:
    """Dequantize int8 values with per-group scales along the last axis."""
    *lead, n = q.shape
    g = q.reshape(*lead, n // group_size, group_size).to(dtype)
    return (g * s[..., None].to(dtype)).reshape(*lead, n)
