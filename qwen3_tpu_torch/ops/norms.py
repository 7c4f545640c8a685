"""RMSNorm (eps hard-coded 1e-6 in the reference engine, src/forward.c:12-28)."""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import RMS_EPS


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = RMS_EPS) -> torch.Tensor:
    """out = w * x / sqrt(mean(x^2) + eps), computed in fp32 over the last axis."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (w.float() * (xf * torch.rsqrt(ms + eps))).to(x.dtype)
