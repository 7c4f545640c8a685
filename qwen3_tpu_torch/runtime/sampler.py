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
- `sample_tokens`: batched PyTorch on the logits' device; only the sampled
  ids cross to the host.

Ties sort by lower token id first (a stable descending sort), as the
reference's qsort does in practice and as jax.lax.top_k / a stable argsort do
in the JAX package; torch.topk promises no tie order, so it is not used.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qwen3_tpu_torch.ops.q8 import const
from qwen3_tpu_torch.runtime.xorshift import XorshiftRng

_EPS = 1e-6
_HEAL_EPS = 1e-3


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


_SCAN_BLOCK = 512


@functools.lru_cache(maxsize=None)
def _ones_upper(n: int, strict: bool, device: torch.device) -> torch.Tensor:
    """[n, n] float32 0/1 matrix with m[i, j] = 1 where i <= j (i < j when
    strict)."""
    return torch.ones(n, n, device=device).triu(1 if strict else 0)


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 prefix sum over the last axis of x [B, n], as two
    products with 0/1 triangular matrices: within blocks of 512, then the
    block totals across blocks. A product runs the same way on every call,
    so the result has the same bits on every run."""
    b, n = x.shape
    c = _SCAN_BLOCK
    nb = -(-n // c)
    xb = torch.nn.functional.pad(x.float(), (0, nb * c - n)).reshape(b, nb, c)
    within = xb @ _ones_upper(c, False, x.device)            # [B, nb, c]
    offsets = within[..., -1] @ _ones_upper(nb, True, x.device)
    return (within + offsets[..., None]).reshape(b, nb * c)[:, :n]


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 prefix sum over the last axis of x [B, n].

    torch.cumsum on a CUDA float tensor is not deterministic (PyTorch's
    use_deterministic_algorithms documentation lists it), so a seeded
    stream could differ from run to run where a coin falls within an ulp of
    a cumulative bound; the card takes blocked_cumsum instead. On the CPU
    torch.cumsum is sequential, the order the JAX package's CPU streams are
    held to."""
    if x.device.type == "cuda":
        return blocked_cumsum(x)
    return torch.cumsum(x, dim=-1, dtype=torch.float32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _nucleus_pick(order: torch.Tensor, sp: torch.Tensor, coin: torch.Tensor,
                  top_p: torch.Tensor, default_idx: int) -> torch.Tensor:
    """Truncation + inverse-CDF over descending (order, probs) [B, n]."""
    cum = cumsum_last(sp)
    exceeded = cum > top_p[:, None]
    idx = torch.where(exceeded.any(dim=-1), _first_true(exceeded),
                      default_idx)
    mass = torch.gather(cum, -1, idx[:, None])[:, 0]
    mass = torch.where(mass < _HEAL_EPS, mass + mass, mass)
    r = coin.float() * mass
    n = sp.shape[-1]
    in_prefix = torch.arange(n, device=sp.device)[None, :] <= idx[:, None]
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

    `top_k_hint` > 0 takes the fast path when the top-k prefix already holds
    more than top_p of the mass: the nucleus then lies inside it and
    sampling over those k candidates is exact. Both paths read the same
    stable descending sort, so they agree with the JAX package's top_k and
    argsort orders."""
    if isinstance(greedy, bool) and greedy:
        return torch.argmax(logits, dim=-1)
    B, V = logits.shape
    temp = _per_row(temperature, logits)
    tp = _per_row(top_p, logits)
    x = logits.float() / temp[:, None]
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    probs = e / torch.sum(e, dim=-1, keepdim=True)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = top_k_hint
    if k and k < V and bool(torch.all(
            torch.sum(sp[:, :k], dim=-1)
            > torch.clamp(tp, min=_HEAL_EPS))):
        sampled = _nucleus_pick(order[:, :k], sp[:, :k], coin, tp, k - 1)
    else:
        sampled = _nucleus_pick(order, sp, coin, tp, V - 1)
    if isinstance(greedy, bool):
        return sampled
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
