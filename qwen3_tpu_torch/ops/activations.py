"""SwiGLU: silu(w1x) * w3x (src/forward.c:122-139 — math must be preserved)."""

from __future__ import annotations

import torch


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, computed in fp32."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)
