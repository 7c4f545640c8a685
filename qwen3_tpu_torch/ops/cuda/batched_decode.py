"""Batched decode-attention partials: the CUDA kernel's wrapper and its plain
version.

Replaces qwen3_tpu/ops/pallas/batched_decode.py::batched_decode_partial, the
serving step's attention over the main KV cache (`attn="fused"`, the
default of `BatchedEngine` at B > 1). The kernel is `csrc/batched_decode.cu`
over `csrc/decode_partial.cuh`; see their headers for the design and the
bound.

The contract is the JAX function's:
  q          [B, H, D] any float dtype (query head r reads kv head r // M)
  k/v_stk    [L, B, S, KV, D] float32, bfloat16 or int8, the stacked cache
  layer      which layer to read (host int)
  row_limit  [B] int: slot b attends rows idx < row_limit[b]
  k/v_s      optional [L, B, S, KV] float32 int8 scales (the JAX function's
             `k/v_sflat` [L, B, S*KV] is the same memory)
  bucket     rows to read, >= max(row_limit) (None: all S)
  -> (acc [B, KV, M, D], m [B, KV, M], l [B, KV, M]) float32, unnormalised:
     acc / l[..., None] is the attention over the slot's rows. A slot with
     row_limit 0 gets (0, finfo.min, 0).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel
launches, one per call that reaches the kernel.
"""

from __future__ import annotations

import math

import torch

from qwen3_tpu_torch.ops.cuda.flash_decode import DTYPE_CODES, MAX_HEAD_DIM
from qwen3_tpu_torch.ops.cuda.flash_decode import decode_counters, pick_ts
from qwen3_tpu_torch.ops.q8 import const

LAUNCHES = {"batched_decode_partial": 0}

_NEG = torch.finfo(torch.float32).min
SPLIT_ROWS = 256     # the kernel's row tile, fixed whatever the bucket


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def batched_decode_plain(q: torch.Tensor, k_stk: torch.Tensor,
                         v_stk: torch.Tensor, layer: int,
                         row_limit: torch.Tensor, k_s=None, v_s=None, *,
                         bucket: int | None, fast: bool = True,
                         block_s: int = 256):
    """The kernel's function in PyTorch, in the Pallas kernel's arithmetic:
    S-tiles of ts = min(block_s, bucket) rows (halved until it divides the
    bucket) in order; per tile scores = (q . k) * (1/sqrt(D)), then times
    the K scale; masked columns to finfo.min with p = 0; the running max
    and rescale; l sums the unscaled p, and the V scale multiplies only the
    value dot's operand p * vs. With `fast` the dot operands are rounded to
    bf16 (q; K and V as stored, exact for int8 and bf16; p * vs)."""
    B, H, D = q.shape
    S, KV = k_stk.shape[2], k_stk.shape[3]
    M = H // KV
    bucket = S if bucket is None else min(bucket, S)
    ts = pick_ts(bucket, block_s)
    rd = _bf16 if fast else (lambda t: t.float())
    qf = rd(q).reshape(B, KV, M, D)
    inv = const(1.0 / math.sqrt(D), qf)
    lim = row_limit.reshape(B)
    span = torch.arange(ts, device=q.device)
    acc = torch.zeros(B, KV, M, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, M, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, KV, M, 1, dtype=torch.float32, device=q.device)
    for s in range(bucket // ts):
        rows = slice(s * ts, (s + 1) * ts)
        kt = rd(k_stk[layer, :, rows]).transpose(1, 2)      # [B, KV, ts, D]
        vt = rd(v_stk[layer, :, rows]).transpose(1, 2)
        scores = torch.matmul(qf, kt.transpose(-1, -2)) * inv   # [B,KV,M,ts]
        if k_s is not None:
            scores = scores * k_s[layer, :, rows].transpose(1, 2)[:, :, None]
        mask = ((s * ts + span)[None, :] < lim[:, None])[:, None, None, :]
        scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new) * mask.float()
        pv = p if v_s is None else (
            p * v_s[layer, :, rows].transpose(1, 2)[:, :, None])
        if fast:
            pv = _bf16(pv)
        acc = acc * alpha + torch.matmul(pv, vt)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        m = m_new
    return acc, m[..., 0], l[..., 0]


def batched_decode_magnitude(q: torch.Tensor, k_stk: torch.Tensor,
                             v_stk: torch.Tensor, layer: int,
                             row_limit: torch.Tensor, k_s=None, v_s=None, *,
                             bucket: int | None) -> torch.Tensor:
    """sum_s p_s * |v_s * vs_s| [B, KV, M, D] in the final frame of the
    fast partials (the m that batched_decode_partial(fast=True) returns,
    exactly for int8 and bf16 K): the plain version over |v| with q rounded
    to bf16 as `fast` rounds it.
    Under `fast` each term's value-dot operand p * vs is rounded to bf16, by
    at most 2^-8 of itself, so this bounds how far a rounding in another
    frame can move each element of acc; the checks of the kernel against
    its plain version use it."""
    return batched_decode_plain(_bf16(q), k_stk, v_stk.abs(), layer,
                                row_limit, k_s, v_s, bucket=bucket,
                                fast=False)[0]


def _check(q, k_stk, v_stk, row_limit, k_s, v_s):
    B, H, D = q.shape
    L, Bk, S, KV, Dk = k_stk.shape
    if (Bk, Dk) != (B, D) or tuple(v_stk.shape) != tuple(k_stk.shape) \
            or H % KV:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k_stk.shape)}, v {tuple(v_stk.shape)}")
    if D < 16 or D > MAX_HEAD_DIM or D & (D - 1):
        raise ValueError(f"head_dim {D} not supported (a power of two from "
                         f"16 to {MAX_HEAD_DIM})")
    if k_stk.dtype not in DTYPE_CODES or v_stk.dtype != k_stk.dtype:
        raise TypeError(f"K/V must share one of {list(DTYPE_CODES)}, got "
                        f"{k_stk.dtype} and {v_stk.dtype}")
    if (k_s is None) != (v_s is None):
        raise ValueError("pass both scales or neither")
    tensors = [("q", q), ("k_stk", k_stk), ("v_stk", v_stk),
               ("row_limit", row_limit)]
    if k_s is not None:
        tensors += [("k_s", k_s), ("v_s", v_s)]
        for name, t in (("k_s", k_s), ("v_s", v_s)):
            if t.dtype != torch.float32 or tuple(t.shape) != (L, B, S, KV):
                raise ValueError(f"{name} must be float32 {(L, B, S, KV)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    if row_limit.dtype != torch.int32 or row_limit.numel() != B:
        raise ValueError(f"row_limit must be int32 with {B} entries")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q, k_stk, v_stk, layer, row_limit, k_s, v_s, bucket, fast):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    B, H, D = q.shape
    L, _, S, KV, _ = k_stk.shape
    M = H // KV
    q = (_bf16(q) if fast else q.float()).contiguous()
    row_limit = row_limit.to(torch.int32).reshape(B).contiguous()
    _check(q, k_stk, v_stk, row_limit, k_s, v_s)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    bucket = S if bucket is None else min(bucket, S)
    n_tiles = -(-bucket // SPLIT_ROWS)
    lib = load_library()
    part_acc = torch.empty(B, KV, n_tiles, M, D, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B, KV, n_tiles, M, 2, dtype=torch.float32,
                          device=q.device)
    acc = torch.empty(B, KV, M, D, dtype=torch.float32, device=q.device)
    m = torch.empty(B, KV, M, dtype=torch.float32, device=q.device)
    l = torch.empty(B, KV, M, dtype=torch.float32, device=q.device)
    ptr = (lambda t: None if t is None else t[layer].data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.batched_decode_partial(
        q.data_ptr(), ptr(k_stk), ptr(v_stk), ptr(k_s), ptr(v_s),
        row_limit.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        decode_counters(q.device, B * H).data_ptr(),
        DTYPE_CODES[k_stk.dtype], int(fast), B, S, H, KV, D, SPLIT_ROWS,
        n_tiles, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"batched_decode_partial kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["batched_decode_partial"] += 1
    return acc, m, l


def batched_decode_partial(q: torch.Tensor, k_stk: torch.Tensor,
                           v_stk: torch.Tensor, layer: int,
                           row_limit: torch.Tensor, k_s=None, v_s=None, *,
                           bucket: int | None, fast: bool = True):
    """Flash partials of batched decode attention over layer `layer` of the
    stacked cache (see the module docstring)."""
    if q.device.type == "cpu":
        return batched_decode_plain(q, k_stk, v_stk, layer, row_limit, k_s,
                                    v_s, bucket=bucket, fast=fast)
    return _launch(q, k_stk, v_stk, int(layer), row_limit, k_s, v_s, bucket,
                   fast)
