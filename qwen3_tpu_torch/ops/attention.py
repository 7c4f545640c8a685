"""GQA attention (reference-semantics path, fp32 softmax).

The reference computes, per head, scores q.k/sqrt(head_dim) over positions
0..pos from an fp32 KV cache, softmax, then a weighted value sum
(src/forward.c:141-195). Here the same math is expressed batched over heads
and positions as masked dense attention.

Layouts:
  q        [B, T, n_heads, head_dim]
  kv cache [B, S, n_kv_heads, head_dim]
GQA maps query head h to kv head h // (n_heads // n_kv_heads).

The dense functions read only the cache's live prefix (`live` rows); the
rows past it are masked, contribute exactly 0, and are never read (the JAX
package gets the same effect from power-of-two prefix buckets).

`fast` is the pallas-fast serving mode's quality class, as in the JAX
package: the dot operands are rounded to bf16 (the cache after its scale),
the products of bf16 values are exact in fp32, and the contraction, softmax
and sums stay fp32. torch.einsum on bf16 tensors would return bf16 and round
every score, so the operands go back to fp32 before the contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_tpu_torch.ops.cuda.batched_decode import batched_decode_partial
from qwen3_tpu_torch.ops.q8 import const
from qwen3_tpu_torch.runtime.kvcache import dequant

_NEG = torch.finfo(torch.float32).min


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to `mask` (bool). Masked
    columns are exactly 0, also in a row with no visible column."""
    s = torch.where(mask, scores, _NEG)
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


def _inv_sqrt(d: int, like: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(f32(D)) rounded to fp32 once, the JAX functions' `inv`."""
    return const(np.float32(1.0) / np.sqrt(np.float32(d)), like)


def dot_operand(x: torch.Tensor, fast: bool) -> torch.Tensor:
    """A dot operand in fp32: rounded to bf16 first when `fast`."""
    if fast:
        return x.to(torch.bfloat16).float()
    return x.float()


def gqa_attention_per_slot(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, positions: torch.Tensor,
                           k_s=None, v_s=None, live: int | None = None,
                           fast: bool = False) -> torch.Tensor:
    """Single-token GQA attention with a distinct position per batch slot.

    q: [B, H, D]; k/v_cache: [B, S, KV, D]; positions: [B] int. Slot b
    attends cache slots 0..positions[b]. `live` (host int, optional) is
    max(positions) + 1, passed to avoid reading it back from the device.
    Returns [B, H, D] fp32."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    n = _live(positions, S, live)
    qf = dot_operand(q, fast).reshape(B, KV, H // KV, D)
    kf = dot_operand(dequant(k_cache[:, :n],
                             None if k_s is None else k_s[:, :n]), fast)
    vf = dot_operand(dequant(v_cache[:, :n],
                             None if v_s is None else v_s[:, :n]), fast)
    scores = _inv_sqrt_div(torch.einsum("bkmd,bskd->bkms", qf, kf), D)
    mask = (torch.arange(n, device=q.device)[None, :]
            <= positions[:, None])                          # [B, n]
    probs = _masked_softmax(scores, mask[:, None, None, :])
    out = torch.einsum("bkms,bskd->bkmd", dot_operand(probs, fast), vf)
    return out.reshape(B, H, D)


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, q_positions: torch.Tensor,
                  k_s=None, v_s=None, live: int | None = None,
                  fast: bool = False) -> torch.Tensor:
    """Dense masked GQA attention against the cache.

    q:           [B, T, H, D] (math in fp32)
    k/v_cache:   [B, S, KV, D]
    q_positions: [T] int — absolute position of each query row; a cache slot
                 s attends iff s <= q_positions[t] (causal over the cache).
    k_s/v_s:     optional [B, S, KV] f32 scales for int8 caches.
    live:        optional host int, max(q_positions) + 1.
    fast:        bf16 dot operands (see the module docstring).

    Returns [B, T, H, D] fp32.
    """
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    n = _live(q_positions, S, live)
    qf = dot_operand(q, fast).reshape(B, T, KV, H // KV, D)
    kf = dot_operand(dequant(k_cache[:, :n],
                             None if k_s is None else k_s[:, :n]), fast)
    vf = dot_operand(dequant(v_cache[:, :n],
                             None if v_s is None else v_s[:, :n]), fast)
    scores = _inv_sqrt_div(torch.einsum("btkmd,bskd->btkms", qf, kf), D)
    mask = (torch.arange(n, device=q.device)[None, :]
            <= q_positions[:, None])                        # [T, n]
    probs = _masked_softmax(scores, mask[None, :, None, None, :])
    out = torch.einsum("btkms,bskd->btkmd", dot_operand(probs, fast), vf)
    return out.reshape(B, T, H, D)


def _side_scores(qf, k_side, k_ss, offsets, fast):
    """The side buffer's scaled scores [B, KV, M, C] and mask [B, C]."""
    C = k_side.shape[1]
    ksf = dot_operand(dequant(k_side, k_ss), fast)
    scores = torch.einsum("bkmd,bckd->bkmc", qf, ksf) * _inv_sqrt(
        qf.shape[-1], qf)
    mask = (torch.arange(C, device=qf.device)[None, :]
            <= offsets[:, None])                           # [B, C]
    return scores, mask


def gqa_attention_two_segment(q: torch.Tensor, k_main: torch.Tensor,
                              v_main: torch.Tensor, k_side: torch.Tensor,
                              v_side: torch.Tensor, base_pos: torch.Tensor,
                              offsets: torch.Tensor, k_ms=None, v_ms=None,
                              k_ss=None, v_ss=None, fast: bool = False,
                              live: int | None = None) -> torch.Tensor:
    """Per-slot decode attention over a main cache prefix plus a chunk side
    buffer (the continuous-batching decode layout: rows < base_pos[b] live
    in the main cache, rows written during the current chunk in the side
    buffer at offsets 0..offsets[b]).

    q [B, H, D]; k/v_main [B, S, KV, D] (one layer); k/v_side [B, C, KV, D];
    base_pos [B] (main rows idx < base_pos[b] attend); offsets [B] (side
    rows j <= offsets[b] attend); scales optional [B, S|C, KV]. `live`
    (host int, optional) is max(base_pos): the main rows read. Scores from
    both segments share one masked softmax. Returns [B, H, D] fp32."""
    B, H, D = q.shape
    S, KV = k_main.shape[1], k_main.shape[2]
    M = H // KV
    if live is None:
        live = int(base_pos.max())
    n = max(1, min(live, S))
    qf = dot_operand(q, fast).reshape(B, KV, M, D)
    scores_s, mask_s = _side_scores(qf, k_side, k_ss, offsets, fast)
    kf = dot_operand(dequant(k_main[:, :n],
                             None if k_ms is None else k_ms[:, :n]), fast)
    scores_m = torch.einsum("bkmd,bskd->bkms", qf, kf) * _inv_sqrt(D, qf)
    mask_m = (torch.arange(n, device=q.device)[None, :]
              < base_pos[:, None])                          # [B, n]
    scores = torch.cat([scores_m, scores_s], dim=-1)
    mask = torch.cat([mask_m, mask_s], dim=-1)[:, None, None, :]
    probs = _masked_softmax(scores, mask)
    vf = dot_operand(dequant(v_main[:, :n],
                             None if v_ms is None else v_ms[:, :n]), fast)
    vsf = dot_operand(dequant(v_side, v_ss), fast)
    out = (torch.einsum("bkms,bskd->bkmd", dot_operand(probs[..., :n], fast),
                        vf)
           + torch.einsum("bkmc,bckd->bkmd",
                          dot_operand(probs[..., n:], fast), vsf))
    return out.reshape(B, H, D)


def fused_batched_attention(q: torch.Tensor, k_main: torch.Tensor,
                            v_main: torch.Tensor, k_side: torch.Tensor,
                            v_side: torch.Tensor, base_pos: torch.Tensor,
                            offsets: torch.Tensor, k_ss=None, v_ss=None, *,
                            k_ms=None, v_ms=None, layer: int,
                            bucket: int | None,
                            fast: bool = True) -> torch.Tensor:
    """Two-segment serving decode attention with the MAIN segment computed
    by the batched decode kernel (ops/cuda/batched_decode.py): K/V rows of
    layer `layer` of the stacked [L, B, S, KV, D] cache, rows < base_pos[b]
    within the host-chosen `bucket`. The chunk side buffer (C rows, already
    layer-sliced) folds into the kernel's partials here under one online
    softmax, in the JAX function's arithmetic.

    q [B, H, D]; k/v_main STACKED [L, B, S, KV, D]; k/v_side [B, C, KV, D];
    base_pos/offsets [B] int32; k/v_ss optional [B, C, KV] side scales;
    k/v_ms optional [L, B, S, KV] main int8 scales (the JAX function's
    `scales_flat` [L, B, S*KV] is the same memory); `bucket` >=
    max(base_pos). Returns [B, H, D] fp32."""
    B, H, D = q.shape
    KV = k_side.shape[2]
    M = H // KV
    acc, m, l = batched_decode_partial(q, k_main, v_main, layer, base_pos,
                                       k_ms, v_ms, bucket=bucket, fast=fast)
    qf = dot_operand(q, fast).reshape(B, KV, M, D)
    scores_s, mask_s = _side_scores(qf, k_side, k_ss, offsets, fast)
    mask4 = mask_s[:, None, None, :]
    scores_s = torch.where(mask4, scores_s, _NEG)
    m_all = torch.maximum(m, torch.amax(scores_s, dim=-1))  # [B, KV, M]
    alpha = torch.exp(m - m_all)
    p = torch.exp(scores_s - m_all[..., None]) * mask4.float()
    vsf = dot_operand(dequant(v_side, v_ss), fast)
    num = acc * alpha[..., None] + torch.einsum(
        "bkmc,bckd->bkmd", dot_operand(p, fast), vsf)
    den = l * alpha + torch.sum(p, dim=-1)
    return (num / den[..., None]).reshape(B, H, D)
