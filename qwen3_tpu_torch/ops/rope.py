"""Rotary position embeddings, NeoX half-split style with theta 1e6.

The reference computes `angle = pos * 1e6^(-i/half_dim)` per token per head
with no cache (src/forward.c:104-118). The port precomputes cos/sin tables
once and gathers rows by position.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_tpu_torch.config import ROPE_THETA


def rope_tables(head_dim: int, max_pos: int, theta: float = ROPE_THETA, *,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) tables of shape [max_pos, head_dim // 2], fp32.

    Computed in float64 on the host and rounded once to float32 (the
    reference's per-step fp32 powf/cosf carries ~1e-4 error at large
    positions)."""
    half = head_dim // 2
    i = np.arange(half, dtype=np.float64)
    freqs = np.power(float(theta), -i / half)
    angles = np.arange(max_pos, dtype=np.float64)[:, None] * freqs[None, :]
    return (torch.from_numpy(np.cos(angles).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(angles).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the last axis of `x` (head_dim, split in halves).

    `cos`/`sin` must broadcast against x[..., :head_dim//2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
