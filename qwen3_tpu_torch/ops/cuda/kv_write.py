"""In-place per-slot KV-cache row writes: the CUDA kernel's wrapper and its
plain version.

Replaces qwen3_tpu/ops/pallas/kv_write.py::kv_write_rows: rows[b] into
cache[layer, b, positions[b]] for every slot b, in one launch, in place. The
kernel is `csrc/kv_write.cu`. As in the JAX package, the runtime does not
call it: models/qwen3.py keeps its indexed writes (the JAX docstring's
caveat is about XLA's scan carries; here it is the same function either way).

  cache     [L, B, S, KV, D] float32 or bfloat16 (written in place, returned)
  rows      [B, KV, D] float (cast to the cache's dtype, bf16 round to
            nearest even)
  layer     int
  positions [B] int (the caller clamps them into [0, S); both versions clamp
            again, so a stray index stays inside the cache)

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

LAUNCHES = {"kv_write": 0}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _positions(positions, B: int, S: int, device) -> torch.Tensor:
    pos = torch.as_tensor(positions, device=device).to(torch.int32)
    if pos.shape != (B,):
        raise ValueError(f"positions must be [{B}], got {tuple(pos.shape)}")
    return pos.clamp(0, S - 1).contiguous()


def _check(cache: torch.Tensor, rows: torch.Tensor, layer: int) -> None:
    if cache.dtype not in DTYPES:
        raise TypeError(f"cache must be float32 or bfloat16, got "
                        f"{cache.dtype}")
    if cache.dim() != 5:
        raise ValueError(f"cache must be [L, B, S, KV, D], got "
                         f"{tuple(cache.shape)}")
    L, B, _, KV, D = cache.shape
    if tuple(rows.shape) != (B, KV, D):
        raise ValueError(f"rows {tuple(rows.shape)} do not match cache "
                         f"{tuple(cache.shape)}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    if rows.device != cache.device:
        raise ValueError(f"rows must be on {cache.device}, got {rows.device}")


def kv_write_rows_plain(cache: torch.Tensor, rows: torch.Tensor, layer: int,
                        positions) -> torch.Tensor:
    """cache[layer, arange(B), positions] = rows.to(cache.dtype), in place."""
    _check(cache, rows, int(layer))
    L, B, S = cache.shape[:3]
    pos = _positions(positions, B, S, cache.device).long()
    cache[int(layer), torch.arange(B, device=cache.device), pos] = rows.to(
        cache.dtype)
    return cache


def kv_write_rows(cache: torch.Tensor, rows: torch.Tensor, layer: int,
                  positions) -> torch.Tensor:
    """Write rows[b] into cache[layer, b, positions[b]] for all b at once;
    returns `cache` (updated in place)."""
    if cache.device.type == "cpu":
        return kv_write_rows_plain(cache, rows, layer, positions)
    from qwen3_tpu_torch.ops.cuda.build import load_library

    layer = int(layer)
    _check(cache, rows, layer)
    L, B, S, KV, D = cache.shape
    src = rows.float().contiguous()
    if not cache.is_contiguous():
        raise ValueError("cache must be contiguous")
    pos = _positions(positions, B, S, cache.device)
    err = load_library().kv_write_rows(
        cache.data_ptr(), src.data_ptr(), pos.data_ptr(), layer, B, S,
        KV * D, int(cache.dtype == torch.bfloat16),
        torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_write_rows kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["kv_write"] += 1
    return cache
