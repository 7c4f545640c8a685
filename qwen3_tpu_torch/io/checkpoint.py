"""Reader/writer for the Q8_0 checkpoint format.

Format (produced by the reference exporter, consumed by the reference C engine):

  [256-byte header]   magic "qwen" u32, version i32, then 10 i32 fields
                      (dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab_size,
                       max_seq_len, head_dim, shared_classifier, group_size),
                      zero-padded to 256 bytes.
                      (ref: qwen3/weights.py:249-293)
  [fp32 section]      att_norm x L*dim, ffn_norm x L*dim, out_norm x dim,
                      q_norm x L*head_dim, k_norm x L*head_dim
                      (ref: qwen3/weights.py:296-329, src/model.c:176-189)
  [Q8_0 section]      per tensor: int8 values then fp32 group scales, in order:
                      embeddings, wq*L, wk*L, wv*L, wo*L, w1*L, w2*L, w3*L,
                      [classifier if untied]
                      (ref: qwen3/weights.py:211-238,331-358, src/model.c:196-244)

Version 2 (a model with sparse experts, Qwen3-30B-A3B) adds three i32 header
fields after group_size: n_experts, n_experts_per_tok, expert_dim
(hidden_dim is then 0), and its Q8_0 section holds, in place of w1, w2 and
w3: the router wr*L ([E, dim] each), then we1*L ([E, width, dim]), we2*L
([E, dim, width]) and we3*L ([E, width, dim]), each layer's tensor whole
(values, then scales), before the classifier. A version-1 file reads
exactly as before; a dense model is written as version 1.

All projection tensors are stored row-major as [out_features, in_features] with
quantization groups of `group_size` consecutive elements along the flattened
buffer — i.e. along the in_features axis, since in_features is always divisible
by group_size for this architecture family.

This module reads the file into stacked per-layer numpy arrays ([L, ...] per
tensor), rather than the reference's per-layer pointer walk; the expert
families stay lists of per-layer views of the mapped file, so that a
30 GB expert model is never copied whole on the host.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from qwen3_tpu_torch.config import (
    HEADER_BYTES,
    QWEN_MAGIC,
    QWEN_VERSION,
    ModelConfig,
    has_experts,
)

# the header version of a model with sparse experts
QWEN_MOE_VERSION = 2


@dataclasses.dataclass
class Q8Weights:
    """Host-side (numpy) Q8_0 weights, stacked across layers.

    `*_q` arrays are int8; `*_s` are fp32 group scales with the group axis last
    (shape [..., out, in // group_size]).

    A model with sparse experts (config.moe) has no w1/w2/w3 (None) and
    carries its router wr [L, E, dim] and its experts' we1 [L, E, width,
    dim], we2 [L, E, dim, width], we3 [L, E, width, dim]; an expert family
    may be a list of L per-layer arrays or tensors, which init_params packs
    one layer at a time (tensors already on the device included).
    """

    config: ModelConfig

    # fp32 norm parameters
    att_norm: np.ndarray   # [L, dim]
    ffn_norm: np.ndarray   # [L, dim]
    out_norm: np.ndarray   # [dim]
    q_norm: np.ndarray     # [L, head_dim]
    k_norm: np.ndarray     # [L, head_dim]

    # Q8_0 tensors: values + per-group scales
    emb_q: np.ndarray      # [V, dim] int8
    emb_s: np.ndarray      # [V, dim // G] f32
    wq_q: np.ndarray       # [L, proj_dim, dim]
    wq_s: np.ndarray       # [L, proj_dim, dim // G]
    wk_q: np.ndarray       # [L, kv_dim, dim]
    wk_s: np.ndarray       # [L, kv_dim, dim // G]
    wv_q: np.ndarray       # [L, kv_dim, dim]
    wv_s: np.ndarray       # [L, kv_dim, dim // G]
    wo_q: np.ndarray       # [L, dim, proj_dim]
    wo_s: np.ndarray       # [L, dim, proj_dim // G]
    cls_q: np.ndarray      # [V, dim] int8 (aliases emb_q when tied)
    cls_s: np.ndarray      # [V, dim // G]
    # the dense MLP (None with experts)
    w1_q: np.ndarray = None       # [L, hidden, dim]
    w1_s: np.ndarray = None       # [L, hidden, dim // G]
    w2_q: np.ndarray = None       # [L, dim, hidden]
    w2_s: np.ndarray = None       # [L, dim, hidden // G]
    w3_q: np.ndarray = None       # [L, hidden, dim]
    w3_s: np.ndarray = None       # [L, hidden, dim // G]
    # the sparse experts (None without)
    wr_q: np.ndarray = None       # [L, E, dim]
    wr_s: np.ndarray = None       # [L, E, dim // G]
    we1_q: np.ndarray = None      # [L, E, width, dim]
    we1_s: np.ndarray = None      # [L, E, width, dim // G]
    we2_q: np.ndarray = None      # [L, E, dim, width]
    we2_s: np.ndarray = None      # [L, E, dim, width // G]
    we3_q: np.ndarray = None      # [L, E, width, dim]
    we3_s: np.ndarray = None      # [L, E, width, dim // G]


def read_header(path: str) -> ModelConfig:
    with open(path, "rb") as f:
        raw = f.read(HEADER_BYTES)
    magic, version = struct.unpack_from("<Ii", raw, 0)
    if magic != QWEN_MAGIC or version not in (QWEN_VERSION, QWEN_MOE_VERSION):
        raise ValueError(
            f"bad checkpoint header: magic=0x{magic:x} version={version}"
        )
    (dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab_size,
     max_seq_len, head_dim, shared_classifier, group_size) = struct.unpack_from(
        "<10i", raw, 8
    )
    experts = (struct.unpack_from("<3i", raw, 48)
               if version == QWEN_MOE_VERSION else (0, 0, 0))
    cfg = ModelConfig(
        dim=dim, hidden_dim=hidden_dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, vocab_size=vocab_size, seq_len=max_seq_len,
        head_dim=head_dim, shared_classifier=bool(shared_classifier),
        group_size=group_size, n_experts=experts[0],
        n_experts_per_tok=experts[1], expert_dim=experts[2],
    )
    cfg.validate()
    return cfg


class _Cursor:
    """Sequential reader over a memory-mapped checkpoint body."""

    def __init__(self, buf: np.memmap, offset: int):
        self.buf = buf
        self.off = offset

    def f32(self, count: int, shape) -> np.ndarray:
        out = self.buf[self.off:self.off + 4 * count].view(np.float32)
        self.off += 4 * count
        return np.ascontiguousarray(out.reshape(shape))

    def i8(self, count: int, shape) -> np.ndarray:
        out = self.buf[self.off:self.off + count].view(np.int8)
        self.off += count
        return np.ascontiguousarray(out.reshape(shape))


def load_checkpoint(path: str) -> Q8Weights:
    cfg = read_header(path)
    L, D, H = cfg.n_layers, cfg.dim, cfg.hidden_dim
    V, HD, G = cfg.vocab_size, cfg.head_dim, cfg.group_size
    P, KV = cfg.proj_dim, cfg.kv_dim

    buf = np.memmap(path, dtype=np.uint8, mode="r")
    cur = _Cursor(buf, HEADER_BYTES)

    att_norm = cur.f32(L * D, (L, D))
    ffn_norm = cur.f32(L * D, (L, D))
    out_norm = cur.f32(D, (D,))
    q_norm = cur.f32(L * HD, (L, HD))
    k_norm = cur.f32(L * HD, (L, HD))

    def q8(n_tensors: int, rows: int, cols: int):
        qs, ss = [], []
        for _ in range(n_tensors):
            qs.append(cur.i8(rows * cols, (rows, cols)))
            ss.append(cur.f32(rows * cols // G, (rows, cols // G)))
        if n_tensors == 1:
            return qs[0], ss[0]
        return np.stack(qs), np.stack(ss)

    def layers(*shape):
        """A family of per-layer tensors [*shape] (views of the file)."""
        qs, ss = [], []
        n = int(np.prod(shape))
        for _ in range(L):
            qs.append(cur.i8(n, shape))
            ss.append(cur.f32(n // G, shape[:-1] + (shape[-1] // G,)))
        return qs, ss

    emb_q, emb_s = q8(1, V, D)
    wq_q, wq_s = q8(L, P, D)
    wk_q, wk_s = q8(L, KV, D)
    wv_q, wv_s = q8(L, KV, D)
    wo_q, wo_s = q8(L, D, P)
    mlp = {}
    if has_experts(cfg):
        E, F = cfg.n_experts, cfg.expert_dim
        wr_q, wr_s = layers(E, D)
        mlp.update(wr_q=np.stack(wr_q), wr_s=np.stack(wr_s))
        for name, shape in (("we1", (E, F, D)), ("we2", (E, D, F)),
                            ("we3", (E, F, D))):
            mlp[name + "_q"], mlp[name + "_s"] = layers(*shape)
    else:
        for name, shape in (("w1", (H, D)), ("w2", (D, H)), ("w3", (H, D))):
            mlp[name + "_q"], mlp[name + "_s"] = q8(L, *shape)
    if cfg.shared_classifier:
        cls_q, cls_s = emb_q, emb_s
    else:
        cls_q, cls_s = q8(1, V, D)

    return Q8Weights(
        config=cfg,
        att_norm=att_norm, ffn_norm=ffn_norm, out_norm=out_norm,
        q_norm=q_norm, k_norm=k_norm,
        emb_q=emb_q, emb_s=emb_s,
        wq_q=wq_q, wq_s=wq_s, wk_q=wk_q, wk_s=wk_s, wv_q=wv_q, wv_s=wv_s,
        wo_q=wo_q, wo_s=wo_s,
        cls_q=cls_q, cls_s=cls_s, **mlp,
    )


def quantize_q8_0(w: np.ndarray, group_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-group Q8_0 quantization of a float array.

    Matches the runtime quantizer semantics (src/q8.c:5-30): per-group absmax
    scale wmax/127 with a 1e-6 zero-guard, round-half-away (C roundf), clamp to
    [-127, 127]. Groups are `group_size` consecutive elements of the flattened
    array. Returns (int8 values with w's shape, fp32 scales [numel // group_size]).
    """
    flat = np.asarray(w, dtype=np.float32).reshape(-1, group_size)
    wmax = np.abs(flat).max(axis=1)
    scale = np.where(wmax == 0.0, np.float32(1e-6), wmax / np.float32(127.0))
    scale = scale.astype(np.float32)
    q = flat / scale[:, None]
    # np.round is banker's rounding; C roundf rounds half away from zero.
    q = np.sign(q) * np.floor(np.abs(q) + 0.5)
    q = np.clip(q, -127, 127).astype(np.int8)
    return q.reshape(np.asarray(w).shape), scale


def dequantize_q8_0(q: np.ndarray, s: np.ndarray, group_size: int) -> np.ndarray:
    flat = q.astype(np.float32).reshape(-1, group_size)
    return (flat * s.reshape(-1, 1)).reshape(q.shape)


def write_checkpoint(path: str, w: Q8Weights) -> None:
    """Serialize Q8Weights into the reference `.bin` layout."""
    cfg = w.config
    moe = has_experts(cfg)
    with open(path, "wb") as f:
        header = struct.pack(
            "<Ii10i", QWEN_MAGIC, QWEN_MOE_VERSION if moe else QWEN_VERSION,
            cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size, cfg.seq_len, cfg.head_dim,
            int(cfg.shared_classifier), cfg.group_size,
        )
        if moe:
            header += struct.pack("<3i", cfg.n_experts, cfg.n_experts_per_tok,
                                  cfg.expert_dim)
        f.write(header + b"\0" * (HEADER_BYTES - len(header)))

        for arr in (w.att_norm, w.ffn_norm, w.out_norm, w.q_norm, w.k_norm):
            f.write(np.ascontiguousarray(arr, dtype=np.float32).tobytes())

        def emit(q: np.ndarray, s: np.ndarray, stacked: bool):
            if stacked:
                for i in range(q.shape[0]):
                    f.write(np.ascontiguousarray(q[i]).tobytes())
                    f.write(np.ascontiguousarray(s[i], dtype=np.float32).tobytes())
            else:
                f.write(np.ascontiguousarray(q).tobytes())
                f.write(np.ascontiguousarray(s, dtype=np.float32).tobytes())

        emit(w.emb_q, w.emb_s, stacked=False)
        emit(w.wq_q, w.wq_s, stacked=True)
        emit(w.wk_q, w.wk_s, stacked=True)
        emit(w.wv_q, w.wv_s, stacked=True)
        emit(w.wo_q, w.wo_s, stacked=True)
        names = ("wr", "we1", "we2", "we3") if moe else ("w1", "w2", "w3")
        for name in names:
            q, s = getattr(w, name + "_q"), getattr(w, name + "_s")
            for i in range(cfg.n_layers):
                emit(np.asarray(q[i]), np.asarray(s[i]), stacked=False)
        if not cfg.shared_classifier:
            emit(w.cls_q, w.cls_s, stacked=False)
