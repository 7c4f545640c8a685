"""Temperature / top-p (nucleus) sampling with reference semantics.

Pipeline per step (src/sampler.c:189-201): scale logits by 1/temperature,
softmax over the full vocab, draw a coin from xorshift64*, then nucleus
sampling (src/sampler.c:165-180): sort probabilities descending, truncate at
the smallest prefix whose cumulative mass exceeds top_p (src/sampler.c:88-112,
including the "mass healing" branch for mass < 1e-3), and pick by inverse CDF
r = coin * mass (src/sampler.c:125-135, with its dist[n-1] fallback).

Parameter clamping matches sampler_create (src/sampler.c:36-52):
top_p -> [1e-6, 1.0] (NaN/+inf -> 1.0), temperature -> [1e-6, inf)
(NaN/+inf -> 1.0). temperature ~ 0 therefore acts as greedy argmax.

Two implementations with identical semantics:
- `Sampler.sample_host`: numpy, the parity oracle;
- `sample_tokens`: batched PyTorch on the logits' device; nothing is read
  back to the host inside it. On the card its two sums (the softmax
  denominator and the prefix sum of the sorted probabilities) run the
  port's fixed-order kernels (csrc/sampler.cu), so a row's token does not
  follow the rows sampled with it.

Ties sort by lower token id first (a stable descending sort), as the
reference's qsort does in practice and as jax.lax.top_k / a stable argsort do
in the JAX package; torch.topk promises no tie order, so it is not used.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qwen3_tpu_torch.ops.cuda import sampler as _cuda
from qwen3_tpu_torch.ops.q8 import const
from qwen3_tpu_torch.runtime.xorshift import XorshiftRng

_EPS = 1e-6
_HEAL_EPS = 1e-3
# sample_tokens calls that sampled (not greedy as a python bool): each runs
# row_sum and cumsum_last once, on the card one launch of each kernel
CALLS = {"sampled": 0}


def clamp_top_p(top_p: float) -> float:
    if math.isnan(top_p) or top_p > 1.0 or top_p == math.inf:
        return 1.0
    if top_p < _EPS or top_p == -math.inf:
        return _EPS
    return top_p


def clamp_temperature(t: float) -> float:
    if math.isnan(t) or t == math.inf:
        return 1.0
    if t < _EPS or t == -math.inf:
        return _EPS
    return t


def top_p_index(cum: np.ndarray, top_p: float) -> int:
    """Smallest index whose cumulative mass exceeds top_p, else last index."""
    exceeded = np.nonzero(cum > np.float32(top_p))[0]
    return int(exceeded[0]) if exceeded.size else cum.shape[0] - 1


def sample_from_probs_host(probs: np.ndarray, coin: float, top_p: float) -> int:
    """Nucleus-sample a token id from a full softmax distribution."""
    order = np.argsort(-probs, kind="stable")
    sp = probs[order].astype(np.float32)
    cum = np.cumsum(sp, dtype=np.float32)
    idx = top_p_index(cum, top_p)
    mass = float(cum[idx])
    if mass < _HEAL_EPS:  # "heal" the truncated distribution
        mass += float(cum[idx])
    r = np.float32(coin) * np.float32(mass)
    hits = np.nonzero(r < cum[: idx + 1])[0]
    pick = int(hits[0]) if hits.size else idx - 1  # C fallback: dist[n-1]
    return int(order[pick])


class Sampler:
    """Host-side sampler with the reference's stateful RNG."""

    def __init__(self, vocab_size: int, temperature: float, top_p: float,
                 seed: int):
        self.vocab_size = vocab_size
        self.temperature = clamp_temperature(temperature)
        self.top_p = clamp_top_p(top_p)
        self.rng = XorshiftRng(seed)

    def sample_host(self, logits: np.ndarray) -> int:
        x = logits.astype(np.float32) / np.float32(self.temperature)
        x -= x.max()
        e = np.exp(x, dtype=np.float32)
        probs = e / e.sum(dtype=np.float32)
        coin = self.rng.next_float()
        return sample_from_probs_host(probs, coin, self.top_p)


def _on_card(x: torch.Tensor) -> bool:
    """Whether x's sums take the fixed-order kernels: a CUDA tensor."""
    return x.device.type == "cuda"


def row_sum(e: torch.Tensor) -> torch.Tensor:
    """Each row's sum of e [B, n] (fp32, [B]): on a CUDA tensor the
    fixed-order kernel (ops/cuda/sampler.py), whose order depends on n
    alone, so a row's softmax denominator does not follow the rows sampled
    with it; torch.sum picks its order by the row count there. On the CPU
    torch.sum, the order the JAX package's CPU streams are held to."""
    if _on_card(e):
        return _cuda.softmax_sum(e.contiguous())
    return torch.sum(e, dim=-1)


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 prefix sum over the last axis of x [B, n].

    On a CUDA tensor the fixed-order kernel (ops/cuda/sampler.py): a
    row's order depends on n alone and its first k sums do not depend on n,
    and the same bits come on every run (torch.cumsum on a CUDA float
    tensor is not deterministic). On the CPU torch.cumsum, which is
    sequential, the order the JAX package's CPU streams are held to."""
    if _on_card(x):
        return _cuda.prefix_sum(x.float().contiguous())
    return torch.cumsum(x, dim=-1, dtype=torch.float32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _nucleus_pick(order: torch.Tensor, cum: torch.Tensor, coin: torch.Tensor,
                  top_p: torch.Tensor, default_idx: int) -> torch.Tensor:
    """Truncation + inverse-CDF over descending `order` [B, n] and the
    prefix sums `cum` [B, n] of its probabilities."""
    exceeded = cum > top_p[:, None]
    idx = torch.where(exceeded.any(dim=-1), _first_true(exceeded),
                      default_idx)
    mass = torch.gather(cum, -1, idx[:, None])[:, 0]
    mass = torch.where(mass < _HEAL_EPS, mass + mass, mass)
    r = coin.float() * mass
    n = cum.shape[-1]
    in_prefix = torch.arange(n, device=cum.device)[None, :] <= idx[:, None]
    hit = (r[:, None] < cum) & in_prefix
    pick = torch.where(hit.any(dim=-1), _first_true(hit), idx - 1) % n
    return torch.gather(order, -1, pick[:, None])[:, 0]


def _per_row(value, like: torch.Tensor) -> torch.Tensor:
    """A python float or [B] tensor as a [B] fp32 tensor on like's device."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32).expand(
            like.shape[0])
    return const(value, like).expand(like.shape[0])


def sample_tokens(logits: torch.Tensor, coin: torch.Tensor, temperature,
                  top_p, greedy=False, top_k_hint: int = 0) -> torch.Tensor:
    """Batched nucleus sampling.

    logits: [B, V] fp32, coin: [B] fp32 in [0,1). Returns [B] int64 token
    ids. `temperature`/`top_p` must already be clamped; each is a python
    float or a [B] tensor. `greedy=True` returns argmax (lowest id on ties);
    a [B] bool tensor applies argmax per row.

    `top_k_hint` > 0 takes the fast path when every row's top-k prefix
    already holds more than top_p of the mass: the nucleus then lies inside
    it and sampling over those k candidates is exact. Both paths read the
    same stable descending sort, so they agree with the JAX package's top_k
    and argsort orders. The choice is the JAX sampler's lax.cond over the
    whole batch, made on the device: both picks are computed and a select
    on the `covered` test takes one, so nothing is read back to the host."""
    if isinstance(greedy, bool) and greedy:
        return torch.argmax(logits, dim=-1)
    CALLS["sampled"] += 1
    B, V = logits.shape
    temp = _per_row(temperature, logits)
    tp = _per_row(top_p, logits)
    x = logits.float() / temp[:, None]
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    probs = e / row_sum(e)[:, None]
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = cumsum_last(sp)
    sampled = _nucleus_pick(order, cum, coin, tp, V - 1)
    k = top_k_hint
    if k and k < V:
        # the top k's mass: on the card the ordered prefix at k - 1 (the
        # k-candidate scan is the full scan's prefix); on the CPU torch.sum
        top = (cum[:, k - 1] if _on_card(cum)
               else torch.sum(sp[:, :k], dim=-1))
        covered = torch.all(top > torch.clamp(tp, min=_HEAL_EPS))
        fast = _nucleus_pick(order[:, :k], cum[:, :k], coin, tp, k - 1)
        sampled = torch.where(covered, fast, sampled)
    if isinstance(greedy, bool):
        return sampled
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
