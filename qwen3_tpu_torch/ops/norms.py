"""RMSNorm (eps hard-coded 1e-6 in the reference engine, src/forward.c:12-28).

On a CUDA tensor both functions run the fixed-order norm kernel
(ops/cuda/norms.py, csrc/rmsnorm.cu), one launch a call, whose order a row
does not share with its batch-mates; on a CPU tensor their plain versions
below, the torch.mean chain, which take any layout.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import RMS_EPS
from qwen3_tpu_torch.ops.cuda import norms as _cuda

DTYPES = (torch.float32, torch.bfloat16)


def _check_dtypes(x: torch.Tensor, w: torch.Tensor | None) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w is not None and w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = RMS_EPS) -> torch.Tensor:
    """out = w * x / sqrt(mean(x^2) + eps), computed in fp32 over the last
    axis by the torch.mean chain."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (w.float() * (xf * torch.rsqrt(ms + eps))).to(x.dtype)


def rms_inv_plain(x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """rsqrt(mean(x^2) + eps) per row [..., 1]: rmsnorm_plain's reduction,
    by the same ops in the same order."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return torch.rsqrt(ms + eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = RMS_EPS) -> torch.Tensor:
    """out = w * x / sqrt(mean(x^2) + eps), computed in fp32 over the last axis."""
    if x.device.type == "cuda":
        return _cuda.rmsnorm_cuda(x, w, eps)
    _check_dtypes(x, w)
    return rmsnorm_plain(x, w, eps)


def rms_inv(x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """rsqrt(mean(x^2) + eps) per row [..., 1]: rmsnorm's reduction, by the
    same ops in the same order, so that w * (x * rms_inv(x)) equals
    rmsnorm(x, w) bit for bit (the fused matmul's "norm" prologue)."""
    if x.device.type == "cuda":
        return _cuda.rms_inv_cuda(x, eps)
    _check_dtypes(x, None)
    return rms_inv_plain(x, eps)
