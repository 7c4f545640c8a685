"""RMSNorm (eps hard-coded 1e-6 in the reference engine, src/forward.c:12-28).

On a CUDA tensor every function runs the fixed-order norm kernel
(ops/cuda/norms.py, csrc/rmsnorm.cu), one launch a call, whose order a row
does not share with its batch-mates; on a CPU tensor its plain version
below, the torch.mean chain, which takes any layout.

Beside rmsnorm and rms_inv, the folds: a norm with the work the layer does
around it, in the same launch on the card and bit-equal there to the chain
they replace, which is their plain version:
  add_rmsnorm(x, y, w) = (x + y, rmsnorm(x + y, w)), the residual add
  before a norm; add_rms_inv(x, y) = (x + y, rms_inv(x + y)), the same for
  the fused matmul's norm prologue;
  qk_norm_rope(q, k, wq, wk, cos, sin) = (apply_rope(rmsnorm(q, wq), cos,
  sin), apply_rope(rmsnorm(k, wk), cos, sin)), the QK-norms and the rope.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import RMS_EPS
from qwen3_tpu_torch.ops.cuda import norms as _cuda
from qwen3_tpu_torch.ops.rope import apply_rope

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


def add_rmsnorm_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                      eps: float = RMS_EPS):
    """(s, rmsnorm_plain(s, w)) with s = x + y."""
    s = x + y
    return s, rmsnorm_plain(s, w, eps)


def add_rms_inv_plain(x: torch.Tensor, y: torch.Tensor,
                      eps: float = RMS_EPS):
    """(s, rms_inv_plain(s)) with s = x + y."""
    s = x + y
    return s, rms_inv_plain(s, eps)


def qk_norm_rope_plain(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
                       wk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       eps: float = RMS_EPS):
    """The QK-norms, then the rope, on q and k: apply_rope(rmsnorm_plain(q,
    wq), cos, sin) and the same for k."""
    return (apply_rope(rmsnorm_plain(q, wq, eps), cos, sin),
            apply_rope(rmsnorm_plain(k, wk, eps), cos, sin))


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                eps: float = RMS_EPS):
    """(s, rmsnorm(s, w)) with s = x + y, rounded as torch.add rounds it:
    the residual add and the norm after it, one launch on the card."""
    if x.device.type == "cuda":
        return _cuda.add_rmsnorm_cuda(x, y, w, eps)
    _check_dtypes(x, w)
    return add_rmsnorm_plain(x, y, w, eps)


def add_rms_inv(x: torch.Tensor, y: torch.Tensor, eps: float = RMS_EPS):
    """(s, rms_inv(s)) with s = x + y: the residual add and the fused
    matmul's row factor, one launch on the card."""
    if x.device.type == "cuda":
        return _cuda.add_rms_inv_cuda(x, y, eps)
    _check_dtypes(x, None)
    return add_rms_inv_plain(x, y, eps)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
                 wk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 eps: float = RMS_EPS):
    """(apply_rope(rmsnorm(q, wq), cos, sin), apply_rope(rmsnorm(k, wk),
    cos, sin)): a layer's QK-norms and rope, one launch for both on the
    card. q [B, T, H, D], k [B, T, KV, D]; cos/sin broadcast against
    [B, T, 1, D / 2] (the prefill's [T, 1, half], a decode step's
    [B, 1, 1, half])."""
    if q.device.type == "cuda":
        return _cuda.qk_norm_rope_cuda(q, k, wq, wk, cos, sin, eps)
    _check_dtypes(q, wq)
    _check_dtypes(k, wk)
    return qk_norm_rope_plain(q, k, wq, wk, cos, sin, eps)
