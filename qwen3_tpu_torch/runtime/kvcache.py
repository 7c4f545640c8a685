"""KV cache with optional int8 quantization.

Each cache side (K or V) is either

- a plain tensor [L, B, S, KV, HD] in float32/bfloat16, or
- a tuple (values int8 [L, B, S, KV, HD], scales f32 [L, B, S, KV]) with a
  symmetric per-(position, head) absmax scale over head_dim, dequantized on
  the fly at the attention read.

The same representation as qwen3_tpu/runtime/kvcache.py. The port writes new
rows in place (the JAX package returns updated arrays); functions still
return the cache so callers read the same either way.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.ops.q8 import const

Q8_MAX = 127.0

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def pad_rows(rows: int, quantum: int = 256) -> int:
    """Round a cache row count up to the flash-kernel tile quantum (the
    rows past every stream's limit are masked out of every read)."""
    return -(-rows // quantum) * quantum


def as_dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                  device):
    """Returns (k_cache, v_cache); each is a tensor or an int8 (q, s) tuple."""
    dtype = as_dtype(dtype)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)

    def one():
        if dtype == torch.int8:
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(shape[:-1], dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    return one(), one()


def make_side(cache, chunk: int):
    """A chunk side buffer [L, B, chunk, KV, D] in `cache`'s storage repr
    (zeros; unit scales for int8): the per-chunk staging area the serving
    decode writes at a uniform step index (models.qwen3.decode_forward's
    `side`)."""
    vals, sc = split(cache)
    L, B, _, KV, D = vals.shape
    side = torch.zeros((L, B, chunk, KV, D), dtype=vals.dtype,
                       device=vals.device)
    if sc is None:
        return side
    return side, torch.ones((L, B, chunk, KV), dtype=torch.float32,
                            device=vals.device)


def split(cache):
    """-> (values, scales_or_None)."""
    if isinstance(cache, tuple):
        return cache
    return cache, None


def join(values, scales):
    return values if scales is None else (values, scales)


def tensors(cache) -> tuple:
    """The cache side's tensors: (values,) or (values, scales)."""
    return cache if isinstance(cache, tuple) else (cache,)


def quantize_heads(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis (head_dim); rounds half
    to even, as jnp.round does."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    s = torch.where(amax == 0.0, const(1e-6, xf), amax / const(Q8_MAX, xf))
    q = torch.clamp(torch.round(xf / s[..., None]), -Q8_MAX, Q8_MAX)
    return q.to(torch.int8), s


def encode_block(cache_values: torch.Tensor, x: torch.Tensor):
    """Convert a new K/V block to the cache's storage representation.

    Returns (values, scales_or_None)."""
    if cache_values.dtype == torch.int8:
        return quantize_heads(x)
    return x.to(cache_values.dtype), None


def dequant(values: torch.Tensor, scales) -> torch.Tensor:
    """fp32 view of (a slice of) the cache."""
    if scales is None:
        return values.float()
    return values.float() * scales[..., None]
