"""GQA attention (reference-semantics path, fp32 softmax).

The reference computes, per head, scores q.k/sqrt(head_dim) over positions
0..pos from an fp32 KV cache, softmax, then a weighted value sum
(src/forward.c:141-195). Here the same math is expressed batched over heads
and positions as masked dense attention.

Layouts:
  q        [B, T, n_heads, head_dim]
  kv cache [B, S, n_kv_heads, head_dim]
GQA maps query head h to kv head h // (n_heads // n_kv_heads).

Both functions read only the cache's live prefix, rows [0, max position];
the rows past it are masked, contribute exactly 0, and are never read (the
JAX package gets the same effect from power-of-two prefix buckets).
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.ops.q8 import const
from qwen3_tpu_torch.runtime.kvcache import dequant


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to `mask` (bool). Masked
    columns are exactly 0, also in a row with no visible column."""
    neg = torch.finfo(torch.float32).min
    s = torch.where(mask, scores, neg)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask.float()
    return p / torch.sum(p, dim=-1, keepdim=True)


def _live(positions: torch.Tensor, s: int, live: int | None) -> int:
    if live is None:
        live = int(positions.max()) + 1
    return max(1, min(live, s))


def _inv_sqrt_div(scores: torch.Tensor, d: int) -> torch.Tensor:
    # a true division by sqrt(D) in fp32, as the JAX package divides
    return scores / torch.sqrt(const(d, scores))


def gqa_attention_per_slot(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, positions: torch.Tensor,
                           k_s=None, v_s=None,
                           live: int | None = None) -> torch.Tensor:
    """Single-token GQA attention with a distinct position per batch slot.

    q: [B, H, D]; k/v_cache: [B, S, KV, D]; positions: [B] int. Slot b
    attends cache slots 0..positions[b]. `live` (host int, optional) is
    max(positions) + 1, passed to avoid reading it back from the device.
    Returns [B, H, D] fp32."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    n = _live(positions, S, live)
    qf = q.float().reshape(B, KV, H // KV, D)
    kf = dequant(k_cache[:, :n], None if k_s is None else k_s[:, :n])
    vf = dequant(v_cache[:, :n], None if v_s is None else v_s[:, :n])
    scores = _inv_sqrt_div(torch.einsum("bkmd,bskd->bkms", qf, kf), D)
    mask = (torch.arange(n, device=q.device)[None, :]
            <= positions[:, None])                          # [B, n]
    probs = _masked_softmax(scores, mask[:, None, None, :])
    out = torch.einsum("bkms,bskd->bkmd", probs, vf)
    return out.reshape(B, H, D)


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, q_positions: torch.Tensor,
                  k_s=None, v_s=None, live: int | None = None) -> torch.Tensor:
    """Dense masked GQA attention against the cache.

    q:           [B, T, H, D] (math in fp32)
    k/v_cache:   [B, S, KV, D]
    q_positions: [T] int — absolute position of each query row; a cache slot
                 s attends iff s <= q_positions[t] (causal over the cache).
    k_s/v_s:     optional [B, S, KV] f32 scales for int8 caches.
    live:        optional host int, max(q_positions) + 1.

    Returns [B, T, H, D] fp32.
    """
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    n = _live(q_positions, S, live)
    qf = q.float().reshape(B, T, KV, H // KV, D)
    kf = dequant(k_cache[:, :n], None if k_s is None else k_s[:, :n])
    vf = dequant(v_cache[:, :n], None if v_s is None else v_s[:, :n])
    scores = _inv_sqrt_div(torch.einsum("btkmd,bskd->btkms", qf, kf), D)
    mask = (torch.arange(n, device=q.device)[None, :]
            <= q_positions[:, None])                        # [T, n]
    probs = _masked_softmax(scores, mask[None, :, None, None, :])
    out = torch.einsum("btkms,bskd->btkmd", probs, vf)
    return out.reshape(B, T, H, D)
