"""Qwen3 forward pass in PyTorch, on the CUDA kernels of `ops/cuda`.

Architecture semantics follow the reference engine (src/forward.c:225-350):
per layer: att-RMSNorm -> Q/K/V quantized matmuls -> per-head QK-RMSNorm then
RoPE (theta 1e6, half-split) -> GQA attention over the KV cache -> output
projection + residual -> FFN-RMSNorm -> w1/w3 -> SwiGLU -> w2 + residual;
finally out-RMSNorm and the (possibly tied) classifier matmul.

The contract is qwen3_tpu/models/qwen3.py's in its five modes:
- "pallas" (the reference's integer math: activations quantized per group,
  int8 x int8 group dots, fp32 scale accumulation; the Q8_0 x Q8_0 kernels);
- "pallas-fast" (the serving mode: activations rounded to bf16 times the
  weights dequantized to bf16, fp32 sums; dense attention with bf16 dot
  operands);
- "pallas-int8" (the JAX package's unadopted experiment: activations
  quantized per (row, 512-wide k-tile), the weight tile requantized to one
  int8 scale per (k-tile, column), int8 dots; attention as pallas-fast);
- "exact" (the reference's integer math as plain products,
  ops/quant_matmul.py::q8_matmul_exact) and "bf16" (weights dequantized once
  to bf16, activations rounded to bf16, ops/quant_matmul.py::
  q8_matmul_bf16); both with separate Q/K/V and W1/W3 products and fp32
  attention.
`forward` runs a [B, T] block from `start_pos`, `decode_forward` one token
per slot at per-slot positions, optionally over the serving engine's chunk
side buffer. Layers run as a Python loop; the KV cache is updated in place.
`fuse=True` (the JAX package's QWEN3_TPU_FUSE=1, which the entry points
read) runs every matmul of modes pallas and pallas-fast through the
prologue-fused kernel: the rmsnorm before wqkv, w13 and the classifier, and
the swiglu before w2, run inside it. Its bits equal the unfused chain's;
only the launches change. The other modes ignore it, as the JAX package's
_make_fused_linear does.

Parameters (a dict of tensors on one device):
  att_norm/ffn_norm [L, dim], out_norm [dim], q_norm/k_norm [L, head_dim]
  emb_q int8 [V, dim], emb_s f32 [V, dim/G]
  pallas modes: wqkv_q [L, P + 2*KVD, dim], w13_q [L, 2*hidden, dim],
  wo_q [L, dim, P], w2_q [L, dim, hidden] (int8, with `_s` f32 group scales
  [..., n/G]): the checkpoint's row-major [out, in] layout, Q/K/V and W1/W3
  fused along out; cls_q/cls_s [V, dim] (the embedding tensors themselves
  when tied)
  exact: wq_q, wk_q, wv_q, wo_q, w1_q, w2_q, w3_q [L, out, in] with `_s`,
  and cls_q/cls_s
  bf16: wq_t .. w3_t [L, in, out] and cls_t [dim, V], bf16 (the JAX
  package's layout)
  rope_cos/rope_sin [max_seq_len, head_dim/2]
  a model with experts (config.has_experts; modes pallas-fast, exact and
  bf16) has no w1/w2/w3 (nor w13) tensors; every mode: wr_q/wr_s the
  router [L, E, dim] (int8, f32 group scales), moe_counts int64 [L, E]
  (the rows routed to each expert so far, expert_counts); pallas-fast and
  exact: we13_q/_s and we2_q/_s, lists of L per-layer tensors [E, 2 *
  width, dim] (each expert's w1 rows, then its w3 rows) and [E, dim,
  width]; bf16: we13_t [E, dim, 2 * width] and we2_t [E, width, dim] per
  layer, bf16
The expert layer (`_moe`): in mode pallas-fast the kernels of
ops/cuda/moe.py (router, index, grouped w13 with its swiglu, grouped w2,
combine; five launches, no read back to the host); in modes exact and bf16
the same routing in plain torch and each expert's products in the mode's
own arithmetic. Modes pallas and pallas-int8 and tensor parallelism do not
run it: they raise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from qwen3_tpu_torch.config import ModelConfig, has_experts
from qwen3_tpu_torch.io.checkpoint import Q8Weights, load_checkpoint
from qwen3_tpu_torch.ops.activations import swiglu
from qwen3_tpu_torch.ops.attention import (
    fused_batched_attention,
    gqa_attention,
    gqa_attention_per_slot,
    gqa_attention_two_segment,
)
from qwen3_tpu_torch.ops.cuda import moe as moe_ops
from qwen3_tpu_torch.ops.cuda.flash_decode import (
    flash_decode_gqa,
    flash_decode_gqa_two_segment,
    flash_prefill_gqa,
)
from qwen3_tpu_torch.ops.cuda.q8_matmul import (
    q8_matmul_fused,
    q8_matmul_stacked_fast,
    q8_matmul_tiled_fast,
    q8_q8_matmul_stacked,
    q8_q8_matmul_tiled,
    q8i8_matmul_stacked,
    q8i8_matmul_tiled,
)
from qwen3_tpu_torch.ops.norms import (
    add_rms_inv,
    add_rmsnorm,
    qk_norm_rope,
    rms_inv,
    rmsnorm,
)
from qwen3_tpu_torch.ops.q8 import dequantize, quantize_act, round_bf16
from qwen3_tpu_torch.ops.quant_matmul import (
    dequant_weights_bf16,
    q8_matmul_bf16,
    q8_matmul_exact,
)
from qwen3_tpu_torch.ops.rope import rope_tables
from qwen3_tpu_torch.parallel.shard_layout import (
    TP_SHARDED_KEYS,
    local_config,
    tp_shard_params,
)
from qwen3_tpu_torch.runtime import kvcache as kvc
from qwen3_tpu_torch.utils.profiling import SPANS

Params = dict[str, Any]

MODES = ("exact", "bf16", "pallas", "pallas-fast", "pallas-int8")
# the modes with a fused-prologue kernel (qwen3_tpu's _make_fused_linear)
FUSE_MODES = ("pallas", "pallas-fast")
# the modes whose attention takes bf16 dot operands
FAST_ATTN_MODES = ("pallas-fast", "pallas-int8")
_FUSED = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3")}
_LAYER_MATS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")

# the modes that run the sparse expert layer
MOE_MODES = ("exact", "bf16", "pallas-fast")

# "fused" (the batched decode kernel) runs only in decode_forward over the
# serving side buffer
ATTN = ("dense", "flash", "fused")

# forward / decode_forward calls, and those of them in mode pallas-fast or
# with a kernel attention (flash decode or prefill; over the side buffer:
# the two-segment flash kernel, or the fused batched decode kernel), for
# checking launch counts against them; and every pass once under the route
# its matmuls took: "mm_" + mode, or "mm_fused" for the fused-prologue kernel
# "forward_step" counts forward's one-token passes at a device position (the
# B = 1 decode chunk), apart from its blocks ("forward"); nothing reads its
# pallas-fast share, so it has no "_fast" key. "moe_layers" counts the
# expert layers run, "moe_rows" the (row, expert) pairs they routed (rows
# times the experts a token takes, padding rows included)
CALLS = {"forward": 0, "decode_forward": 0, "forward_step": 0,
         "forward_flash": 0, "decode_forward_flash": 0,
         "forward_step_flash": 0, "forward_fast": 0,
         "decode_forward_fast": 0,
         "decode_forward_two_segment": 0, "decode_forward_fused": 0,
         "mm_pallas": 0, "mm_pallas-fast": 0, "mm_pallas-int8": 0,
         "mm_exact": 0, "mm_bf16": 0, "mm_fused": 0,
         "moe_layers": 0, "moe_rows": 0}


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
        raise ValueError(f"unknown qmode {mode!r} (the port runs {MODES})")


def check_moe(cfg: ModelConfig, mode: str, sharded: bool = False) -> None:
    """A model with experts runs in MOE_MODES unsharded (tp = 1); anything
    else is not ported, and raises (nothing falls back)."""
    if not has_experts(cfg):
        return
    if mode not in MOE_MODES:
        raise NotImplementedError(
            f"qmode {mode!r} with experts is not ported (the expert layer "
            f"runs {MOE_MODES})")
    if sharded:
        raise NotImplementedError(
            "tensor parallelism with experts is not ported")


def _bf16_host(q: np.ndarray, s: np.ndarray, group_size: int) -> torch.Tensor:
    """Q8_0 weights [..., d, n] to bf16 [..., n, d] on the host, one layer
    at a time (qwen3_tpu's _dequant_bf16_host: bounds the fp32 transient)."""
    if q.ndim == 2:
        return dequant_weights_bf16(torch.from_numpy(np.array(q)),
                                    torch.from_numpy(np.array(s)), group_size)
    return torch.stack([_bf16_host(q[i], s[i], group_size)
                        for i in range(q.shape[0])])


def _host_params(w: Q8Weights, mode: str) -> dict:
    """Host parameter dict for `mode` (everything but the rope tables):
    numpy arrays, and bf16 tensors in mode bf16 (numpy has no bf16)."""
    check_mode(mode)
    check_moe(w.config, mode)
    p = {
        "att_norm": w.att_norm, "ffn_norm": w.ffn_norm,
        "out_norm": w.out_norm, "q_norm": w.q_norm, "k_norm": w.k_norm,
        "emb_q": w.emb_q, "emb_s": w.emb_s,
    }
    # a model with experts has no dense MLP: attention's matrices alone
    moe = has_experts(w.config)
    mats = _LAYER_MATS[:4] if moe else _LAYER_MATS
    fused = {"wqkv": _FUSED["wqkv"]} if moe else _FUSED
    if mode == "bf16":
        g = w.config.group_size
        for name in mats:
            p[name + "_t"] = _bf16_host(getattr(w, name + "_q"),
                                        getattr(w, name + "_s"), g)
        p["cls_t"] = _bf16_host(w.cls_q, w.cls_s, g)
        return p
    if mode == "exact":
        for name in mats:
            p[name + "_q"] = getattr(w, name + "_q")
            p[name + "_s"] = getattr(w, name + "_s")
    else:   # every pallas mode packs the same tensors
        for out_name, parts in fused.items():
            p[out_name + "_q"] = np.concatenate(
                [getattr(w, n + "_q") for n in parts], axis=-2)
            p[out_name + "_s"] = np.concatenate(
                [getattr(w, n + "_s") for n in parts], axis=-2)
        for name in ("wo",) if moe else ("wo", "w2"):
            p[name + "_q"] = getattr(w, name + "_q")
            p[name + "_s"] = getattr(w, name + "_s")
    if not w.config.shared_classifier:
        p["cls_q"], p["cls_s"] = w.cls_q, w.cls_s
    return p


def _tensor(a) -> torch.Tensor:
    """A host array as a tensor that owns its memory: np.array copies
    (checkpoint arrays are read-only views of the file); a numpy bf16
    (ml_dtypes) array goes through its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_device(host: dict, cfg: ModelConfig, max_seq_len: int,
               device) -> Params:
    p: Params = {k: _tensor(v).to(device) for k, v in host.items()}
    if "cls_q" not in p and "cls_t" not in p:
        # tied classifier: the embedding tensors themselves
        p["cls_q"], p["cls_s"] = p["emb_q"], p["emb_s"]
    p["rope_cos"], p["rope_sin"] = rope_tables(cfg.head_dim, max_seq_len,
                                               device=device)
    return p


def _free(family, l: int) -> None:
    """Let go of layer l of a family given as a list of layers."""
    if isinstance(family, list):
        family[l] = None


def _expert_params(w: Q8Weights, mode: str, dev) -> Params:
    """The expert layer's parameters of `mode` on `dev` (see the module
    docstring), one layer at a time: each family's layer l (an array or a
    tensor, host or device, stacked [L, ...] or a list of layers) is copied
    or packed on `dev`, w1 and w3 into w13, and a family given as a list
    lets go of each layer once it is packed, so that handing over tensors
    already on the card holds at most the model and one layer."""
    cfg = w.config
    L, E, G = cfg.n_layers, cfg.n_experts, cfg.group_size

    def layer(family, l):
        return _tensor(family[l]).to(dev)

    p: Params = {"moe_counts": torch.zeros(L, E, dtype=torch.int64,
                                           device=dev)}
    for part in ("_q", "_s"):
        src = getattr(w, "wr" + part)
        p["wr" + part] = (torch.stack([layer(src, l) for l in range(L)])
                          if isinstance(src, list) else _tensor(src).to(dev))
        for l in range(L):
            _free(src, l)
    keys = ("we13_t", "we2_t") if mode == "bf16" else (
        "we13_q", "we13_s", "we2_q", "we2_s")
    for k in keys:
        p[k] = []
    for l in range(L):
        if mode == "bf16":
            up = [dequant_weights_bf16(layer(w.we1_q, l), layer(w.we1_s, l), G),
                  dequant_weights_bf16(layer(w.we3_q, l), layer(w.we3_s, l), G)]
            p["we13_t"].append(torch.cat(up, dim=-1))
            p["we2_t"].append(dequant_weights_bf16(layer(w.we2_q, l),
                                                   layer(w.we2_s, l), G))
            del up
        else:
            for part in ("_q", "_s"):
                p["we13" + part].append(torch.cat(
                    [layer(getattr(w, "we1" + part), l),
                     layer(getattr(w, "we3" + part), l)], dim=-2))
                p["we2" + part].append(
                    layer(getattr(w, "we2" + part), l).contiguous())
        for name in ("we1", "we2", "we3"):
            _free(getattr(w, name + "_q"), l)
            _free(getattr(w, name + "_s"), l)
    return p


def init_params(w: Q8Weights, mode: str = "pallas",
                max_seq_len: int | None = None, device="cuda") -> Params:
    """Device parameters of `mode` from Q8 weights: host arrays, or (the
    expert families) tensors already on the device, packed there."""
    dev = resolve_device(device)
    if max_seq_len is None:
        max_seq_len = w.config.seq_len
    p = _to_device(_host_params(w, mode), w.config, max_seq_len, dev)
    if has_experts(w.config):
        p.update(_expert_params(w, mode, dev))
    return p


def load_params(path: str, mode: str = "pallas",
                max_seq_len: int | None = None, device="cuda", *,
                tp: int = 1, rank: int = 0) -> tuple[ModelConfig, Params]:
    """Read a checkpoint into device parameters of `mode`. Returns
    (ModelConfig, Params). The layouts need no repack, so there is no disk
    cache.

    `tp` > 1 reads tensor-parallel rank `rank`'s shard of the pallas layout
    (parallel/shard_layout.py::tp_shard_params) straight from the
    checkpoint: only the shard reaches the device. The ModelConfig
    returned is the global one. As in the JAX package, tp > 1 takes a
    pallas mode (exact and bf16 shard a full parameter dict by
    parallel.sharding.shard_params)."""
    check_mode(mode)
    if tp > 1 and not mode.startswith("pallas"):
        raise ValueError(
            "tp>1 requires a pallas mode (exact/bf16 shard via "
            "parallel.sharding.shard_params instead)")
    dev = resolve_device(device)
    w = load_checkpoint(path)
    check_moe(w.config, mode, tp > 1)
    if max_seq_len is None:
        max_seq_len = w.config.seq_len
    if has_experts(w.config):
        return w.config, init_params(w, mode, max_seq_len, dev)
    host = tp_shard_params(_host_params(w, mode), w.config, tp, rank)
    return w.config, _to_device(host, w.config, max_seq_len, dev)


def untile(a, d: int) -> np.ndarray:
    """qwen3_tpu's repack_tiles layout [..., J, r, td] (columns zero-padded
    to J * td) back to row-major [..., d, r]."""
    a = np.asarray(a)
    j, r, td = a.shape[-3:]
    a = np.moveaxis(a, -3, -2).reshape(*a.shape[:-3], r, j * td)
    return np.ascontiguousarray(np.swapaxes(a[..., :d], -1, -2))


def params_from_jax(jax_params: dict, cfg: ModelConfig, *,
                    device, rank: int = 0) -> Params:
    """The port's parameters from qwen3_tpu's pytree of any mode, each leaf
    a numpy array. A pallas pytree (every pallas mode packs the same
    tensors) is un-tiled from the [L, J, n, td] / [J, n, td] repack back to
    row-major [.., d, n], without the classifier's zero padding; the exact
    pytree's row-major tensors and the bf16 pytree's [.., in, out] bf16
    tensors carry over as they are.

    qwen3_tpu's tensor-parallel pytree (parallel/tp.py::tp_host_params, the
    sharded leaves under a leading [tp, ...] axis) gives tensor-parallel
    rank `rank` its shard: the rank's slice of each sharded leaf, un-tiled
    at the shard's dims (the classifier's vocab/tp rows, padding rows
    included)."""
    dev = resolve_device(device)
    if "wqkv_q" in jax_params and np.asarray(jax_params["wqkv_q"]).ndim == 5:
        tp = np.asarray(jax_params["wqkv_q"]).shape[0]
        shard = {k: (np.asarray(v)[rank] if k in TP_SHARDED_KEYS else v)
                 for k, v in jax_params.items()}
        return params_from_jax(shard, local_config(cfg, tp), device=dev)
    host = {k: np.asarray(jax_params[k]) for k in (
        "att_norm", "ffn_norm", "out_norm", "q_norm", "k_norm",
        "emb_q", "emb_s")}
    if "wq_t" in jax_params or "wq_q" in jax_params:     # bf16 or exact
        for k, v in jax_params.items():
            if k.startswith(("w", "cls_")):
                host[k] = np.asarray(v)
        max_seq_len = np.asarray(jax_params["rope_cos"]).shape[0]
        return _to_device(host, cfg, max_seq_len, dev)
    d_out = {
        "wqkv": cfg.proj_dim + 2 * cfg.kv_dim, "wo": cfg.dim,
        "w13": 2 * cfg.hidden_dim, "w2": cfg.dim, "cls": cfg.vocab_size,
    }
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
            layer: int | None, mode: str) -> torch.Tensor:
    """qwen3_tpu's _make_linear. Mode pallas: reference-exact integer math,
    activations quantized per group (src/forward.c:259), then the Q8_0 x
    Q8_0 kernel. Mode pallas-fast: activations rounded to bf16, then the
    fast kernel (weights dequantized to bf16, fp32 sums). Mode pallas-int8:
    the int8 requantized kernel (it quantizes x per (row, k-tile)). Modes
    exact and bf16: ops/quant_matmul.py."""
    if mode == "exact":
        xq, xs = quantize_act(x, cfg.group_size)
        w_q, w_s = p[name + "_q"], p[name + "_s"]
        if layer is not None:
            w_q, w_s = w_q[layer], w_s[layer]
        return q8_matmul_exact(xq, xs, w_q, w_s, cfg.group_size)
    if mode == "bf16":
        w_t = p[name + "_t"]
        return q8_matmul_bf16(x, w_t if layer is None else w_t[layer])
    if mode == "pallas-int8":
        if layer is None:
            return q8i8_matmul_tiled(x, p[name + "_q"], p[name + "_s"],
                                     cfg.group_size)
        return q8i8_matmul_stacked(x, p[name + "_q"], p[name + "_s"], layer,
                                   cfg.group_size)
    if mode == "pallas-fast":
        xb = round_bf16(x)
        if layer is None:
            return q8_matmul_tiled_fast(xb, p[name + "_q"], p[name + "_s"],
                                        cfg.group_size)
        return q8_matmul_stacked_fast(xb, p[name + "_q"], p[name + "_s"],
                                      layer, cfg.group_size)
    xq, xs = quantize_act(x, cfg.group_size)
    if layer is None:
        return q8_q8_matmul_tiled(xq, xs, p[name + "_q"], p[name + "_s"],
                                  cfg.group_size)
    return q8_q8_matmul_stacked(xq, xs, p[name + "_q"], p[name + "_s"],
                                layer, cfg.group_size)


def _fused(p: Params, cfg: ModelConfig, x: torch.Tensor, name: str,
           layer: int | None, mode: str, prologue: str,
           nw: torch.Tensor | None = None,
           inv: torch.Tensor | None = None) -> torch.Tensor:
    """qwen3_tpu's _make_fused_linear: the prologue-fused kernel against
    layer `layer`'s weights (the classifier's for None); exact in mode
    pallas, bf16 in pallas-fast. "norm" takes x's rms_inv (`inv`, or
    computed here) and `nw`."""
    w_q, w_s = p[name + "_q"], p[name + "_s"]
    if layer is not None:
        w_q, w_s = w_q[layer], w_s[layer]
    if prologue == "norm" and inv is None:
        inv = rms_inv(x)
    return q8_matmul_fused(x, w_q, w_s, cfg.group_size, inv, nw,
                           prologue=prologue, exact=mode == "pallas")


def _count_pass(kind: str, mode: str, fuse: bool) -> bool:
    """Count one forward pass of `kind` in CALLS; returns whether its
    matmuls take the fused-prologue kernel (fuse in a mode that has it)."""
    fuse = fuse and mode in FUSE_MODES
    CALLS[kind] += 1
    if kind != "forward_step":
        CALLS[kind + "_fast"] += mode == "pallas-fast"
    CALLS["mm_fused" if fuse else "mm_" + mode] += 1
    return fuse


def _check_attn(attn: str) -> None:
    if attn not in ATTN:
        raise NotImplementedError(
            f"attn={attn!r} is not ported yet (the port runs {ATTN})")


def _reduce(group, y: torch.Tensor) -> torch.Tensor:
    """The tensor-parallel sum of a row-parallel matmul's partials over
    `group` (parallel/comm.py: in rank order); y itself without one."""
    return y if group is None else group.sum(y)


def _add_norm(x: torch.Tensor, d: torch.Tensor | None,
              w: torch.Tensor | None):
    """The residual stream x + d and its norm in one launch: (x + d,
    rmsnorm(x + d, w)), or (x + d, rms_inv(x + d)) for w None (the fused
    matmul's prologue); x itself where there is no d to add."""
    if d is None:
        return x, (rms_inv(x) if w is None else rmsnorm(x, w))
    return add_rms_inv(x, d) if w is None else add_rmsnorm(x, d, w)


def _layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
           d: torch.Tensor | None, l: int, cos, sin, write_kv, attend,
           mode: str, fuse: bool, group=None):
    """One transformer layer on the residual stream x + d, x [B, T, dim] and
    d the previous layer's w2 delta (None at layer 0): the attention norm
    adds it in its own launch (ops/norms.py's folds). Returns (the stream
    after the attention's residual add, this layer's w2 delta, not yet
    added): the next layer's attention norm, or the caller before the
    classifier, adds it. `write_kv(l, k, v)` stores the new rows,
    `attend(l, q)` returns attention [B, T, H, D]. Modes exact and bf16 run
    separate q/k/v and w1/w3 products on one normed h (the JAX package's
    unfused layout); `fuse` (pallas modes only) runs the prologue-fused
    kernel, its norm's row factor from the same folds. Under tensor
    parallelism (`group`, cfg the shard's) the layer's two reductions
    follow wo and w2, and the adds take the reduced deltas."""
    B, T = x.shape[:2]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = mode not in ("exact", "bf16")
    if fuse:
        x, inv = _add_norm(x, d, None)
        qkv = _fused(p, cfg, x, "wqkv", l, mode, "norm", p["att_norm"][l],
                     inv)
    else:
        x, h = _add_norm(x, d, p["att_norm"][l])
    if split:
        if not fuse:
            qkv = _linear(p, cfg, h, "wqkv", l, mode)
        q = qkv[..., :H * D].reshape(B, T, H, D)
        k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D)
        v = qkv[..., (H + KV) * D:(H + 2 * KV) * D].reshape(B, T, KV, D)
    else:
        q = _linear(p, cfg, h, "wq", l, mode).reshape(B, T, H, D)
        k = _linear(p, cfg, h, "wk", l, mode).reshape(B, T, KV, D)
        v = _linear(p, cfg, h, "wv", l, mode).reshape(B, T, KV, D)
    q, k = qk_norm_rope(q, k, p["q_norm"][l], p["k_norm"][l], cos, sin)
    write_kv(l, k, v)
    att = attend(l, q).reshape(B, T, H * D)
    if fuse:
        wo = _reduce(group, _fused(p, cfg, att, "wo", l, mode, "none"))
        if has_experts(cfg):
            x, h = _add_norm(x, wo, p["ffn_norm"][l])
            return x, _moe(p, cfg, h, l, mode)
        x, inv = _add_norm(x, wo, None)
        gu = _fused(p, cfg, x, "w13", l, mode, "norm", p["ffn_norm"][l], inv)
        return x, _reduce(group, _fused(p, cfg, gu, "w2", l, mode, "swiglu"))
    x, h = _add_norm(x, _reduce(group, _linear(p, cfg, att, "wo", l, mode)),
                     p["ffn_norm"][l])
    if has_experts(cfg):
        return x, _moe(p, cfg, h, l, mode)
    if split:
        gu = _linear(p, cfg, h, "w13", l, mode)
        gate, up = gu[..., :cfg.hidden_dim], gu[..., cfg.hidden_dim:]
    else:
        gate = _linear(p, cfg, h, "w1", l, mode)
        up = _linear(p, cfg, h, "w3", l, mode)
    return x, _reduce(group, _linear(p, cfg, swiglu(gate, up), "w2", l,
                                     mode))


def _moe(p: Params, cfg: ModelConfig, h: torch.Tensor, l: int,
         mode: str) -> torch.Tensor:
    """Layer l's sparse expert layer on its ffn_norm output h [B, T, dim]:
    the router in float32 over all experts, the top n_experts_per_tok by
    softmax probability renormalised, each routed (row, expert) pair
    through the expert's SwiGLU, the outputs summed with their weights in
    descending order (ops/cuda/moe.py). Returns its w2 delta [B, T, dim]
    f32, unadded, as the dense branch does. Span `moe`; counted in CALLS."""
    sid = SPANS.begin("moe")
    B, T, D = h.shape
    k = cfg.n_experts_per_tok
    CALLS["moe_layers"] += 1
    CALLS["moe_rows"] += B * T * k
    h2 = h.reshape(B * T, D)
    if mode == "pallas-fast":
        out = moe_ops.expert_layer(
            h2, p["wr_q"][l], p["wr_s"][l], p["we13_q"][l], p["we13_s"][l],
            p["we2_q"][l], p["we2_s"][l], k, cfg.group_size,
            p["moe_counts"][l])
    else:
        out = _moe_plain(p, cfg, h2, l, mode)
    SPANS.end(sid)
    return out.reshape(B, T, D)


def _moe_plain(p: Params, cfg: ModelConfig, h: torch.Tensor, l: int,
               mode: str) -> torch.Tensor:
    """The expert layer of modes exact and bf16 on h [N, dim]: the routing
    and the combine of pallas-fast in plain torch, each expert's products
    in the mode's own arithmetic (_linear's: activations quantized per
    group against the Q8_0 weights, or bf16 against the weights dequantized
    once to bf16)."""
    G, k, F = cfg.group_size, cfg.n_experts_per_tok, cfg.expert_dim
    ids, w, _ = moe_ops.route_plain(h, p["wr_q"][l], p["wr_s"][l], k, G)
    lst, cnt = moe_ops.index_plain(ids, cfg.n_experts, p["moe_counts"][l])
    if mode == "exact":
        def mm(a, name, e):
            aq, as_ = quantize_act(a, G)
            return q8_matmul_exact(aq, as_, p[name + "_q"][l][e],
                                   p[name + "_s"][l][e], G)
    else:
        def mm(a, name, e):
            return q8_matmul_bf16(a, p[name + "_t"][l][e])
    y = torch.zeros(ids.numel(), cfg.dim, dtype=torch.float32,
                    device=h.device)
    for e, c in enumerate(cnt.tolist()):
        if c:
            ent = lst[e, :c].long()
            gu = mm(h[ent // k], "we13", e)
            y[ent] = mm(swiglu(gu[:, :F], gu[:, F:]), "we2", e)
    return moe_ops.combine_plain(y, w)


def expert_counts(p: Params) -> torch.Tensor:
    """The rows routed to each (layer, expert) since the parameters were
    made, int64 [L, E] on the host: the routing kernels add to it on the
    device, and this read synchronizes, so it is taken only when asked,
    never inside a step."""
    return p["moe_counts"].cpu()


def _layers(p: Params, cfg: ModelConfig, x: torch.Tensor, cos, sin,
            write_kv, attend, mode: str, fuse: bool,
            group=None) -> torch.Tensor:
    """Every layer over x [B, T, dim]; the last layer's w2 delta added
    plainly at the end (one PyTorch add a pass)."""
    d = None
    for l in range(cfg.n_layers):
        x, d = _layer(p, cfg, x, d, l, cos, sin, write_kv, attend, mode,
                      fuse, group)
    return x + d


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor,
            mode: str, fuse: bool, group=None,
            out_vocab: int | None = None) -> torch.Tensor:
    """The classifier's logits; under tensor parallelism the vocab-sharded
    segments all-gathered in rank order and sliced to `out_vocab` (the
    global vocab: the padding sits after the last segment)."""
    if fuse:
        out = _fused(p, cfg, x, "cls", None, mode, "norm", p["out_norm"])
    else:
        out = _linear(p, cfg, rmsnorm(x, p["out_norm"]), "cls", None, mode)
    out = out[..., :cfg.vocab_size]
    if group is not None:
        out = group.cat(out, -1)
        if out_vocab is not None:
            out = out[..., :out_vocab]
    return out


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor, k_cache,
            v_cache, start_pos, *, mode: str = "pallas",
            all_logits: bool = False, attn: str = "dense", last_pos=None,
            fuse: bool = False, live: int | None = None, group=None,
            out_vocab: int | None = None):
    """Run a [B, T] block of tokens starting at absolute position `start_pos`.

    `last_pos` (optional): position within the block whose logits to return
    when `all_logits` is False (default: the last); a host int, or an [N]
    int tensor with one position per row (batched admission: prompts padded
    to one block width end at different rows). The block must fit the
    cache: rows start_pos .. start_pos + T - 1 are written.

    `start_pos` is a host int, or for T = 1 a 0-dim int64 tensor on the
    device (the B = 1 decode chunk, qwen3_tpu's forward_impl at a traced
    position): nothing is then read back to the host. The row is written
    by index_copy_ at the position clamped into the cache, as the JAX
    package's dynamic_update_slice clamps it, and `live` (a host int,
    required then) bounds the attention's rows: at least the position + 1;
    the rows past the position are masked, so `live` sizes the work, never
    the result.

    `attn="flash"` runs the flash kernels (qwen3_tpu's forward_impl
    routing): flash decode for T == 1, with the position broadcast over B,
    and flash prefill for T > 1. Modes pallas-fast and pallas-int8 run the
    dense attention with bf16 dot operands, as the JAX package does.
    `fuse`: the prologue-fused matmuls in modes pallas and pallas-fast
    (ignored in the others, see the module docstring).

    `group` (qwen3_tpu's `axis_name`): running tensor-parallel on one
    rank's shard (parallel/tp.py), the tp axis's parallel.comm.Group; `cfg`
    then holds the shard's dims (n_heads/tp, n_kv_heads/tp, hidden/tp,
    vocab/tp). The only collectives are one sum after each row-parallel
    matmul (wo, w2) and one all-gather of the vocab-sharded logits, sliced
    to `out_vocab` (the global vocab). None (the default) at tp = 1.

    Returns (logits [B, T, V] or [B, 1, V], k_cache, v_cache)."""
    check_mode(mode)
    check_moe(cfg, mode, group is not None)
    _check_attn(attn)
    if attn == "fused":
        raise ValueError("attn='fused' is the serving decode step's attention "
                         "over the side buffer (decode_forward with side=); "
                         "a block runs 'dense' or 'flash'")
    fast = mode in FAST_ATTN_MODES
    B, T = tokens.shape
    k_vals, k_sc = kvc.split(k_cache)
    v_vals, v_sc = kvc.split(v_cache)
    S = k_vals.shape[2]
    on_device = isinstance(start_pos, torch.Tensor)
    if on_device:
        if T != 1 or live is None or not 1 <= live <= S:
            raise ValueError(f"a device start_pos takes one token and a host "
                             f"live in [1, {S}]; got T={T}, live={live}")
        kind = "forward_step"
    else:
        if start_pos < 0 or start_pos + T > S:
            raise ValueError(f"block [{start_pos}, {start_pos + T}) outside "
                             f"the {S}-row cache")
        live = start_pos + T
        kind = "forward"
    fuse = _count_pass(kind, mode, fuse)
    x = _embed(p, cfg, tokens)                              # [B, T, dim]
    positions = start_pos + torch.arange(T, device=x.device)
    rp = positions.clamp(max=p["rope_cos"].shape[0] - 1)
    cos = p["rope_cos"][rp][:, None, :]                     # [T, 1, half]
    sin = p["rope_sin"][rp][:, None, :]
    if attn == "flash":
        CALLS[kind + "_flash"] += 1
        pos32 = positions.to(torch.int32)
        if T == 1:
            pos32 = pos32.expand(B).contiguous()

    if on_device:
        at = positions.clamp(0, S - 1)                      # [1]

        def put(cache, l, x):
            cache[l].index_copy_(1, at, x)
    else:
        rows = slice(start_pos, start_pos + T)

        def put(cache, l, x):
            cache[l, :, rows] = x

    def write_kv(l, k, v):
        k_enc, k_es = kvc.encode_block(k_vals, k)
        v_enc, v_es = kvc.encode_block(v_vals, v)
        put(k_vals, l, k_enc)
        put(v_vals, l, v_enc)
        if k_es is not None:
            put(k_sc, l, k_es)
            put(v_sc, l, v_es)

    def attend(l, q):
        # layer l's cache as the contiguous views k_vals[l] / k_sc[l]
        ks = None if k_sc is None else k_sc[l]
        vs = None if v_sc is None else v_sc[l]
        if attn == "flash" and T == 1:
            return flash_decode_gqa(q[:, 0], k_vals[l], v_vals[l], pos32, ks,
                                    vs, live=live)[:, None]
        if attn == "flash":
            return flash_prefill_gqa(q, k_vals[l], v_vals[l], pos32, ks, vs,
                                     live=live)
        return gqa_attention(q, k_vals[l], v_vals[l], positions, ks, vs,
                             live=live, fast=fast)

    x = _layers(p, cfg, x, cos, sin, write_kv, attend, mode, fuse, group)

    if not all_logits:
        if isinstance(last_pos, torch.Tensor) and last_pos.dim() == 1:
            rows_b = torch.arange(B, device=x.device)
            x = x[rows_b, last_pos.to(x.device)][:, None]
        else:
            i = T - 1 if last_pos is None else int(last_pos)
            x = x[:, i:i + 1]
    return (_logits(p, cfg, x, mode, fuse, group, out_vocab), k_cache,
            v_cache)


def decode_forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   k_cache, v_cache, positions: torch.Tensor, *,
                   mode: str = "pallas", attn: str = "dense",
                   live: int | None = None, side=None,
                   attn_bucket: int | None = None, fuse: bool = False,
                   group=None, out_vocab: int | None = None):
    """Batched single-token decode with per-slot positions.

    tokens: [B] int, positions: [B] int (each stream at its own absolute
    position).

    Without `side`: each slot's K/V row is written at its own position
    (already clamped into the cache by the caller). `live` (host int,
    optional) is max(positions) + 1. `attn="flash"` runs the flash decode
    kernel at the per-slot positions. Returns (logits [B, V], k_cache,
    v_cache).

    With `side=(k_side, v_side, base_pos, step)` (qwen3_tpu's
    decode_forward_impl `side` mode, the serving chunk): the main cache is
    READ ONLY (rows idx < base_pos[b]); the new K/V rows go into the chunk
    side buffers [L, B, C, KV, D] at the uniform host index `step`, and
    attention runs over both segments: "dense" gqa_attention_two_segment,
    "flash" the two-segment flash kernel, "fused" the batched decode kernel
    over the stacked main cache within `attn_bucket` rows (host-chosen,
    >= max(base_pos)) with the side buffer folded in. `live` is then
    max(base_pos). Returns (logits [B, V], k_side, v_side); the serving
    loop merges the side rows into the main cache once per chunk.

    Modes pallas-fast and pallas-int8 take bf16 dot operands in the dense
    and fused attention (the flash kernels stay fp32, as in the JAX
    package). `fuse`, `group` and `out_vocab` as in `forward`."""
    check_mode(mode)
    check_moe(cfg, mode, group is not None)
    _check_attn(attn)
    if attn == "fused" and side is None:
        raise ValueError("attn='fused' runs over the serving side buffer "
                         "only: pass side=(k_side, v_side, base_pos, step)")
    fast = mode in FAST_ATTN_MODES
    fuse = _count_pass("decode_forward", mode, fuse)
    B = tokens.shape[0]
    k_vals, k_sc = kvc.split(k_cache)
    v_vals, v_sc = kvc.split(v_cache)
    x = _embed(p, cfg, tokens[:, None])                     # [B, 1, dim]
    rp = positions.clamp(0, p["rope_cos"].shape[0] - 1)
    cos = p["rope_cos"][rp][:, None, None, :]               # [B, 1, 1, half]
    sin = p["rope_sin"][rp][:, None, None, :]
    if side is not None:
        return _decode_side(p, cfg, x, cos, sin, k_vals, v_vals, k_sc, v_sc,
                            positions, side, mode, attn, live, attn_bucket,
                            fuse, group, out_vocab)
    slots = torch.arange(B, device=x.device)
    if live is None:
        live = int(positions.max()) + 1
    if attn == "flash":
        CALLS["decode_forward_flash"] += 1
        pos32 = positions.to(torch.int32).contiguous()

    def write_kv(l, k, v):
        k_enc, k_es = kvc.encode_block(k_vals, k[:, 0])
        v_enc, v_es = kvc.encode_block(v_vals, v[:, 0])
        k_vals[l, slots, positions] = k_enc
        v_vals[l, slots, positions] = v_enc
        if k_es is not None:
            k_sc[l, slots, positions] = k_es
            v_sc[l, slots, positions] = v_es

    def attend(l, q):
        ks = None if k_sc is None else k_sc[l]
        vs = None if v_sc is None else v_sc[l]
        if attn == "flash":
            return flash_decode_gqa(q[:, 0], k_vals[l], v_vals[l], pos32, ks,
                                    vs, live=live)[:, None]
        return gqa_attention_per_slot(q[:, 0], k_vals[l], v_vals[l],
                                      positions, ks, vs, live=live,
                                      fast=fast)[:, None]

    x = _layers(p, cfg, x, cos, sin, write_kv, attend, mode, fuse, group)
    return (_logits(p, cfg, x, mode, fuse, group, out_vocab)[:, 0], k_cache,
            v_cache)


def _decode_side(p, cfg, x, cos, sin, k_vals, v_vals, k_sc, v_sc, positions,
                 side, mode, attn, live, attn_bucket, fuse, group, out_vocab):
    """decode_forward's side-buffer form (see there)."""
    fast = mode in FAST_ATTN_MODES
    k_side, v_side, base_pos, step = side
    sk, sk_sc = kvc.split(k_side)
    sv, sv_sc = kvc.split(v_side)
    base32 = base_pos.to(torch.int32).contiguous()
    off32 = (positions - base_pos).to(torch.int32).contiguous()
    if live is None and attn != "fused":
        live = int(base_pos.max())
    if attn == "flash":
        CALLS["decode_forward_two_segment"] += 1
    elif attn == "fused":
        CALLS["decode_forward_fused"] += 1

    def write_kv(l, k, v):
        # all B rows share the step index: one uniform write per buffer
        k_enc, k_es = kvc.encode_block(sk, k[:, 0])
        v_enc, v_es = kvc.encode_block(sv, v[:, 0])
        sk[l, :, step] = k_enc
        sv[l, :, step] = v_enc
        if k_es is not None:
            sk_sc[l, :, step] = k_es
            sv_sc[l, :, step] = v_es

    def attend(l, q):
        kms = None if k_sc is None else k_sc[l]
        vms = None if v_sc is None else v_sc[l]
        kss = None if sk_sc is None else sk_sc[l]
        vss = None if sv_sc is None else sv_sc[l]
        if attn == "flash":
            return flash_decode_gqa_two_segment(
                q[:, 0], k_vals[l], v_vals[l], sk[l], sv[l], base32, off32,
                kms, vms, kss, vss, live=live)[:, None]
        if attn == "fused":
            return fused_batched_attention(
                q[:, 0], k_vals, v_vals, sk[l], sv[l], base32, off32, kss,
                vss, k_ms=k_sc, v_ms=v_sc, layer=l, bucket=attn_bucket,
                fast=fast)[:, None]
        return gqa_attention_two_segment(
            q[:, 0], k_vals[l], v_vals[l], sk[l], sv[l], base_pos,
            off32, kms, vms, kss, vss, fast=fast, live=live)[:, None]

    x = _layers(p, cfg, x, cos, sin, write_kv, attend, mode, fuse, group)
    return (_logits(p, cfg, x, mode, fuse, group, out_vocab)[:, 0], k_side,
            v_side)
