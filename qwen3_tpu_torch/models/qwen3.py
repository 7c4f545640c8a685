"""Qwen3 forward pass in PyTorch, on the CUDA kernels of `ops/cuda`.

Architecture semantics follow the reference engine (src/forward.c:225-350):
per layer: att-RMSNorm -> Q/K/V quantized matmuls -> per-head QK-RMSNorm then
RoPE (theta 1e6, half-split) -> GQA attention over the KV cache -> output
projection + residual -> FFN-RMSNorm -> w1/w3 -> SwiGLU -> w2 + residual;
finally out-RMSNorm and the (possibly tied) classifier matmul.

The contract is qwen3_tpu/models/qwen3.py's in mode "pallas" (the reference's
integer math: activations quantized per group, int8 x int8 group dots, fp32
scale accumulation): `forward` runs a [B, T] block from `start_pos`,
`decode_forward` one token per slot at per-slot positions. Layers run as a
Python loop; the KV cache is updated in place.

Parameters (a dict of tensors on one device):
  att_norm/ffn_norm [L, dim], out_norm [dim], q_norm/k_norm [L, head_dim]
  emb_q int8 [V, dim], emb_s f32 [V, dim/G]
  wqkv_q [L, P + 2*KVD, dim], w13_q [L, 2*hidden, dim], wo_q [L, dim, P],
  w2_q [L, dim, hidden] (int8, with `_s` f32 group scales [..., n/G]): the
  checkpoint's row-major [out, in] layout, Q/K/V and W1/W3 fused along out
  cls_q/cls_s [V, dim] (the embedding tensors themselves when tied)
  rope_cos/rope_sin [max_seq_len, head_dim/2]
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.io.checkpoint import Q8Weights, load_checkpoint
from qwen3_tpu_torch.ops.activations import swiglu
from qwen3_tpu_torch.ops.attention import gqa_attention, gqa_attention_per_slot
from qwen3_tpu_torch.ops.cuda.q8_matmul import (
    q8_q8_matmul_stacked,
    q8_q8_matmul_tiled,
)
from qwen3_tpu_torch.ops.norms import rmsnorm
from qwen3_tpu_torch.ops.q8 import dequantize, quantize_act
from qwen3_tpu_torch.ops.rope import apply_rope, rope_tables
from qwen3_tpu_torch.runtime import kvcache as kvc

Params = dict[str, Any]

MODES = ("pallas",)
_FUSED = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3")}
_LAYER_MATS = ("wqkv", "wo", "w13", "w2")

# forward / decode_forward calls, for checking launch counts against them
CALLS = {"forward": 0, "decode_forward": 0}


def resolve_device(device) -> torch.device:
    """The device to run on. "cuda" without a card raises: the port never
    falls back to the CPU on its own. Also pins full-fp32 matmul numerics
    (TF32 off), the JAX package's Precision.HIGHEST."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' (CLI: --device cpu) to run the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise NotImplementedError(
            f"qmode {mode!r} is not ported yet (the port runs 'pallas')")


def _host_params(w: Q8Weights) -> dict:
    """Numpy parameter dict (everything but the rope tables)."""
    p = {
        "att_norm": w.att_norm, "ffn_norm": w.ffn_norm,
        "out_norm": w.out_norm, "q_norm": w.q_norm, "k_norm": w.k_norm,
        "emb_q": w.emb_q, "emb_s": w.emb_s,
    }
    for out_name, parts in _FUSED.items():
        p[out_name + "_q"] = np.concatenate(
            [getattr(w, n + "_q") for n in parts], axis=-2)
        p[out_name + "_s"] = np.concatenate(
            [getattr(w, n + "_s") for n in parts], axis=-2)
    for name in ("wo", "w2"):
        p[name + "_q"] = getattr(w, name + "_q")
        p[name + "_s"] = getattr(w, name + "_s")
    if not w.config.shared_classifier:
        p["cls_q"], p["cls_s"] = w.cls_q, w.cls_s
    return p


def _to_device(host: dict, cfg: ModelConfig, max_seq_len: int,
               device) -> Params:
    # np.array copies: checkpoint arrays are read-only views of the file
    p: Params = {k: torch.from_numpy(np.array(v)).to(device)
                 for k, v in host.items()}
    if "cls_q" not in p:  # tied classifier: the embedding tensors themselves
        p["cls_q"], p["cls_s"] = p["emb_q"], p["emb_s"]
    p["rope_cos"], p["rope_sin"] = rope_tables(cfg.head_dim, max_seq_len,
                                               device=device)
    return p


def init_params(w: Q8Weights, mode: str = "pallas",
                max_seq_len: int | None = None, device="cuda") -> Params:
    """Device parameters from host Q8 weights."""
    check_mode(mode)
    dev = resolve_device(device)
    if max_seq_len is None:
        max_seq_len = w.config.seq_len
    return _to_device(_host_params(w), w.config, max_seq_len, dev)


def load_params(path: str, mode: str = "pallas",
                max_seq_len: int | None = None,
                device="cuda") -> tuple[ModelConfig, Params]:
    """Read a checkpoint into device parameters. Returns (ModelConfig,
    Params). The layout needs no repack, so there is no disk cache."""
    check_mode(mode)
    dev = resolve_device(device)
    w = load_checkpoint(path)
    if max_seq_len is None:
        max_seq_len = w.config.seq_len
    return w.config, _to_device(_host_params(w), w.config, max_seq_len, dev)


def untile(a, d: int) -> np.ndarray:
    """qwen3_tpu's repack_tiles layout [..., J, r, td] (columns zero-padded
    to J * td) back to row-major [..., d, r]."""
    a = np.asarray(a)
    j, r, td = a.shape[-3:]
    a = np.moveaxis(a, -3, -2).reshape(*a.shape[:-3], r, j * td)
    return np.ascontiguousarray(np.swapaxes(a[..., :d], -1, -2))


def params_from_jax(jax_params: dict, cfg: ModelConfig, *,
                    device) -> Params:
    """The port's parameters from qwen3_tpu's mode-"pallas" pytree, each leaf
    a numpy array: un-tiles the [L, J, n, td] / [J, n, td] repack back to
    row-major [.., d, n] and drops the classifier's zero padding."""
    dev = resolve_device(device)
    d_out = {
        "wqkv": cfg.proj_dim + 2 * cfg.kv_dim, "wo": cfg.dim,
        "w13": 2 * cfg.hidden_dim, "w2": cfg.dim, "cls": cfg.vocab_size,
    }
    host = {k: np.asarray(jax_params[k]) for k in (
        "att_norm", "ffn_norm", "out_norm", "q_norm", "k_norm",
        "emb_q", "emb_s")}
    for name, d in d_out.items():
        host[name + "_q"] = untile(jax_params[name + "_q"], d)
        host[name + "_s"] = untile(jax_params[name + "_s"], d)
    max_seq_len = np.asarray(jax_params["rope_cos"]).shape[0]
    return _to_device(host, cfg, max_seq_len, dev)


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                  device):
    """(k_cache, v_cache): tensors for float dtypes, (values, scales) tuples
    for int8 (see runtime/kvcache.py)."""
    return kvc.init_kv_cache(cfg, batch, seq_len, dtype, device)


def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Dequantized embedding rows (the reference's fp32 table)."""
    return dequantize(p["emb_q"][tokens], p["emb_s"][tokens], cfg.group_size)


def _linear(p: Params, cfg: ModelConfig, x: torch.Tensor, name: str,
            layer: int | None) -> torch.Tensor:
    """Reference-exact integer math: quantize activations per group
    (src/forward.c:259), then the Q8_0 x Q8_0 kernel."""
    xq, xs = quantize_act(x, cfg.group_size)
    if layer is None:
        return q8_q8_matmul_tiled(xq, xs, p[name + "_q"], p[name + "_s"],
                                  cfg.group_size)
    return q8_q8_matmul_stacked(xq, xs, p[name + "_q"], p[name + "_s"],
                                layer, cfg.group_size)


def _check_attn(attn: str) -> None:
    if attn != "dense":
        raise NotImplementedError(
            f"attn={attn!r} is not ported yet: the flash attention kernels "
            f"(qwen3_tpu/ops/pallas/flash_decode.py) come with the next "
            f"slice; depth >= 8192 under --attn auto needs them")


def _layer(p: Params, cfg: ModelConfig, x: torch.Tensor, l: int, cos, sin,
           write_kv, attend) -> torch.Tensor:
    """One transformer layer on x [B, T, dim]; `write_kv(l, k, v)` stores
    the new rows, `attend(l, q)` returns attention [B, T, H, D]."""
    B, T = x.shape[:2]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = _linear(p, cfg, rmsnorm(x, p["att_norm"][l]), "wqkv", l)
    q = qkv[..., :H * D].reshape(B, T, H, D)
    k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D)
    v = qkv[..., (H + KV) * D:(H + 2 * KV) * D].reshape(B, T, KV, D)
    q = apply_rope(rmsnorm(q, p["q_norm"][l]), cos, sin)
    k = apply_rope(rmsnorm(k, p["k_norm"][l]), cos, sin)
    write_kv(l, k, v)
    att = attend(l, q).reshape(B, T, H * D)
    x = x + _linear(p, cfg, att, "wo", l)
    gu = _linear(p, cfg, rmsnorm(x, p["ffn_norm"][l]), "w13", l)
    gate, up = gu[..., :cfg.hidden_dim], gu[..., cfg.hidden_dim:]
    return x + _linear(p, cfg, swiglu(gate, up), "w2", l)


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, p["out_norm"])
    return _linear(p, cfg, x, "cls", None)[..., :cfg.vocab_size]


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor, k_cache,
            v_cache, start_pos: int, *, mode: str = "pallas",
            all_logits: bool = False, attn: str = "dense",
            last_pos: int | None = None):
    """Run a [B, T] block of tokens starting at absolute position `start_pos`.

    `last_pos` (host int, optional): position within the block whose logits
    to return when `all_logits` is False (default: the last). The block
    must fit the cache: rows start_pos .. start_pos + T - 1 are written.

    Returns (logits [B, T, V] or [B, 1, V], k_cache, v_cache)."""
    check_mode(mode)
    _check_attn(attn)
    CALLS["forward"] += 1
    B, T = tokens.shape
    k_vals, k_sc = kvc.split(k_cache)
    v_vals, v_sc = kvc.split(v_cache)
    if start_pos < 0 or start_pos + T > k_vals.shape[2]:
        raise ValueError(f"block [{start_pos}, {start_pos + T}) outside the "
                         f"{k_vals.shape[2]}-row cache")
    x = _embed(p, cfg, tokens)                              # [B, T, dim]
    positions = start_pos + torch.arange(T, device=x.device)
    rp = positions.clamp(max=p["rope_cos"].shape[0] - 1)
    cos = p["rope_cos"][rp][:, None, :]                     # [T, 1, half]
    sin = p["rope_sin"][rp][:, None, :]
    rows = slice(start_pos, start_pos + T)

    def write_kv(l, k, v):
        k_enc, k_es = kvc.encode_block(k_vals, k)
        v_enc, v_es = kvc.encode_block(v_vals, v)
        k_vals[l, :, rows] = k_enc
        v_vals[l, :, rows] = v_enc
        if k_es is not None:
            k_sc[l, :, rows] = k_es
            v_sc[l, :, rows] = v_es

    def attend(l, q):
        return gqa_attention(q, k_vals[l], v_vals[l], positions,
                             None if k_sc is None else k_sc[l],
                             None if v_sc is None else v_sc[l],
                             live=start_pos + T)

    for l in range(cfg.n_layers):
        x = _layer(p, cfg, x, l, cos, sin, write_kv, attend)

    if not all_logits:
        i = T - 1 if last_pos is None else int(last_pos)
        x = x[:, i:i + 1]
    return _logits(p, cfg, x), k_cache, v_cache


def decode_forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   k_cache, v_cache, positions: torch.Tensor, *,
                   mode: str = "pallas", attn: str = "dense",
                   live: int | None = None):
    """Batched single-token decode with per-slot positions.

    tokens: [B] int, positions: [B] int (each stream at its own absolute
    position, already clamped into the cache by the caller). Each slot's
    K/V row is written at its own position. `live` (host int, optional) is
    max(positions) + 1.

    Returns (logits [B, V], k_cache, v_cache)."""
    check_mode(mode)
    _check_attn(attn)
    CALLS["decode_forward"] += 1
    B = tokens.shape[0]
    k_vals, k_sc = kvc.split(k_cache)
    v_vals, v_sc = kvc.split(v_cache)
    x = _embed(p, cfg, tokens[:, None])                     # [B, 1, dim]
    rp = positions.clamp(0, p["rope_cos"].shape[0] - 1)
    cos = p["rope_cos"][rp][:, None, None, :]               # [B, 1, 1, half]
    sin = p["rope_sin"][rp][:, None, None, :]
    slots = torch.arange(B, device=x.device)
    if live is None:
        live = int(positions.max()) + 1

    def write_kv(l, k, v):
        k_enc, k_es = kvc.encode_block(k_vals, k[:, 0])
        v_enc, v_es = kvc.encode_block(v_vals, v[:, 0])
        k_vals[l, slots, positions] = k_enc
        v_vals[l, slots, positions] = v_enc
        if k_es is not None:
            k_sc[l, slots, positions] = k_es
            v_sc[l, slots, positions] = v_es

    def attend(l, q):
        return gqa_attention_per_slot(
            q[:, 0], k_vals[l], v_vals[l], positions,
            None if k_sc is None else k_sc[l],
            None if v_sc is None else v_sc[l], live=live)[:, None]

    for l in range(cfg.n_layers):
        x = _layer(p, cfg, x, l, cos, sin, write_kv, attend)
    return _logits(p, cfg, x)[:, 0], k_cache, v_cache
