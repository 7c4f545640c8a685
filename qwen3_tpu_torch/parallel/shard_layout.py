"""Which part of each pallas-mode parameter a tensor-parallel rank holds
(the pure half of qwen3_tpu/parallel/tp.py: check_tp, local_config,
TP_SHARDED_KEYS and the shard function).

Each rank packs its own shard of the fused matrices, in the port's
row-major [L, d_out, n] layout (there is no tile repack):
- wqkv = [q_s | k_s | v_s]: rank s owns query heads [s*Hl, (s+1)*Hl) and kv
  heads [s*KVl, (s+1)*KVl); w13 = [w1_s | w3_s]: hidden rows [s*hl, (s+1)*hl);
- wo and w2 are row-parallel: the input slice matching the heads or hidden
  rows the rank produced. Q8 group boundaries always align with shard
  boundaries (check_tp), so a shard's activation groups are the global
  ones and the integer math stays the reference's;
- the classifier is vocab-sharded; the vocab is padded with zero rows and
  zero scales up to a multiple of tp (exactly-0.0 logits, removed by the
  slice after the all-gather).

This module imports only the config, numpy and torch: the model's loader
and the mesh programs (parallel/tp.py) both read it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qwen3_tpu_torch.config import ModelConfig

# parameter keys a rank holds its own shard of
TP_SHARDED_KEYS = frozenset(
    name + part
    for name in ("wqkv", "w13", "wo", "w2", "cls")
    for part in ("_q", "_s")
)


def check_tp(cfg: ModelConfig, tp: int) -> None:
    if tp == 1:
        return
    if cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads}")
    hl = cfg.hidden_dim // tp
    if cfg.hidden_dim % tp or hl % cfg.group_size:
        raise ValueError(
            f"hidden_dim={cfg.hidden_dim} must split into tp={tp} chunks "
            f"divisible by group_size={cfg.group_size}")
    if (cfg.head_dim * cfg.n_heads // tp) % cfg.group_size:
        raise ValueError("per-shard proj_dim must be divisible by group_size")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The shard-local architecture: heads, kv heads, hidden rows and vocab
    columns divided by tp. `vocab_size` becomes the shard's valid column
    count (global vocab padded up to a tp multiple, then split)."""
    check_tp(cfg, tp)
    v_pad = -(-cfg.vocab_size // tp) * tp
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp,
        hidden_dim=cfg.hidden_dim // tp,
        vocab_size=v_pad // tp,
    )


def _own(a):
    """A slice as an array of its own: a device slice must not keep the
    full tensor alive."""
    if isinstance(a, torch.Tensor):
        return a.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(a)


def _cat(parts, axis: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _pad_rows(a, rows: int):
    """a [V, ...] with zero rows appended up to `rows`."""
    if a.shape[0] == rows:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((rows - a.shape[0],)
                                         + tuple(a.shape[1:]))])
    return np.pad(a, [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def tp_shard_params(p: dict, cfg: ModelConfig, tp: int, rank: int) -> dict:
    """Rank `rank`'s shard of a full pallas-mode parameter dict (numpy
    arrays or tensors, as models.qwen3 packs them; a tied classifier may be
    absent, or the embedding tensors themselves). Replicated leaves carry
    over as they are; the sharded ones (TP_SHARDED_KEYS) are the rank's
    own copies. At tp = 1 the dict is returned as it is."""
    check_tp(cfg, tp)
    if tp == 1:
        return dict(p)
    D, G, s = cfg.head_dim, cfg.group_size, rank
    Hl, KVl = cfg.n_heads // tp, cfg.n_kv_heads // tp
    hl = cfg.hidden_dim // tp
    P, KVD, hidden = cfg.proj_dim, cfg.kv_dim, cfg.hidden_dim
    out = {k: v for k, v in p.items() if k not in TP_SHARDED_KEYS}

    def rows(a, lo, hi):        # a slice of the output axis of [.., out, in]
        return a[..., lo:hi, :]

    for part in ("_q", "_s"):
        a = p["wqkv" + part]
        out["wqkv" + part] = _own(_cat([
            rows(a, s * Hl * D, (s + 1) * Hl * D),
            rows(a, P + s * KVl * D, P + (s + 1) * KVl * D),
            rows(a, P + KVD + s * KVl * D, P + KVD + (s + 1) * KVl * D),
        ], -2))
        a = p["w13" + part]
        out["w13" + part] = _own(_cat([
            rows(a, s * hl, (s + 1) * hl),
            rows(a, hidden + s * hl, hidden + (s + 1) * hl)], -2))
    # row-parallel: the input slice; the group scales follow (the slice is
    # a multiple of the group size, check_tp)
    for name, w in (("wo", Hl * D), ("w2", hl)):
        out[name + "_q"] = _own(p[name + "_q"][..., s * w:(s + 1) * w])
        out[name + "_s"] = _own(
            p[name + "_s"][..., s * w // G:(s + 1) * w // G])
    v_pad = -(-cfg.vocab_size // tp) * tp
    vl = v_pad // tp
    for part in ("_q", "_s"):
        a = p.get("cls" + part, p["emb" + part])
        out["cls" + part] = _own(_pad_rows(a, v_pad)[s * vl:(s + 1) * vl])
    return out
