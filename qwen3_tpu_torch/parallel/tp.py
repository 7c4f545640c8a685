"""Tensor- and data-parallel execution of the pallas modes: the mesh
programs (qwen3_tpu/parallel/tp.py's contract). Which shard of each
parameter a rank holds is parallel/shard_layout.py's.

Each layer has exactly two reductions, one after wo and one after w2, and
the logits one all-gather (models.qwen3.forward's `group`). The KV cache
shards its kv heads over tp and its batch over dp.

The JAX package runs one controller and shard_map; here each program is a
plain function that runs on one rank's shard, and every rank of the mesh
calls it with the same arguments (the same host scheduler on the same
requests). Per-slot state that JAX shards over dp stays whole on every
rank's host; a rank's device holds its dp share of the slots. The serving
engines call the same plain functions (runtime/engine.py,
runtime/batched.py); these closures are their counterparts of the JAX
package's programs.
"""

from __future__ import annotations

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.io.checkpoint import Q8Weights
from qwen3_tpu_torch.models.qwen3 import (
    _host_params,
    decode_forward,
    forward,
)
from qwen3_tpu_torch.parallel.shard_layout import local_config, tp_shard_params
from qwen3_tpu_torch.runtime.batched import (
    mesh_prefill_slot_chunk,
    mesh_prefill_slots_chunk,
)
from qwen3_tpu_torch.runtime.decode_loop import (
    batched_decode_chunk,
    decode_chunk,
)


def tp_host_params(w: Q8Weights, tp: int, rank: int) -> dict:
    """Host (numpy) pallas-mode parameters of rank `rank` (the JAX
    package's tp_host_params gives every shard under a leading [tp, ...]
    axis; a rank here reads its own only)."""
    return tp_shard_params(_host_params(w, "pallas"), w.config, tp, rank)


def make_tp_forward(mesh, cfg: ModelConfig, *, mode: str = "pallas",
                    attn: str = "dense", fuse: bool = False):
    """The tensor/data-parallel forward on this rank's shard: (params,
    tokens [b, T] (the rank's dp rows), k, v, start_pos, last_pos) ->
    (logits [b, 1, V], k, v), the logits whole on every tp rank."""
    loc = local_config(cfg, mesh.tp)

    def fn(params, tokens, k, v, start_pos, last_pos=None):
        return forward(params, loc, tokens, k, v, start_pos, mode=mode,
                       attn=attn, last_pos=last_pos, fuse=fuse,
                       group=mesh.tp_group, out_vocab=cfg.vocab_size)
    return fn


def make_tp_decode_step(mesh, cfg: ModelConfig, *, mode: str = "pallas",
                        attn: str = "dense", fuse: bool = False):
    """The serving decode step on this rank's shard: (params, tokens [b],
    k, v, positions [b]) -> (logits [b, V], k, v)."""
    loc = local_config(cfg, mesh.tp)

    def fn(params, tokens, k, v, positions):
        return decode_forward(params, loc, tokens, k, v, positions,
                              mode=mode, attn=attn, fuse=fuse,
                              group=mesh.tp_group, out_vocab=cfg.vocab_size)
    return fn


def make_tp_decode_chunk(mesh, cfg: ModelConfig, **statics):
    """runtime.decode_loop.decode_chunk on this rank's shard (single stream,
    B = 1; the mesh's dp must be 1). `statics` are the chunk's keyword
    arguments (mode/chunk/temperature/top_p/greedy/bos/eos/emit_at_limit/
    top_k/attn/fuse)."""
    if mesh.dp != 1:
        raise ValueError("single-stream decode_chunk runs with dp=1")
    loc = local_config(cfg, mesh.tp)

    def fn(params, k, v, token, pos, limit, hi, lo):
        return decode_chunk(params, loc, k, v, token, pos, limit, hi, lo,
                            group=mesh.tp_group, out_vocab=cfg.vocab_size,
                            **statics)
    return fn


def make_tp_batched_chunk(mesh, cfg: ModelConfig, **statics):
    """runtime.decode_loop.batched_decode_chunk on the mesh: the per-slot
    [B] host state is whole on every rank, a rank's cache holds its dp
    share of the slots, and each step's sampled ids are all-gathered over
    dp before the host reads them, so every rank's host sees the same
    state."""
    loc = local_config(cfg, mesh.tp)

    def fn(params, k, v, token, pos, limit, done, rng, temp, topp, emit):
        return batched_decode_chunk(
            params, loc, k, v, token, pos, limit, done, rng, temp, topp,
            emit, group=mesh.tp_group, out_vocab=cfg.vocab_size,
            dp_group=mesh.dp_group, **statics)
    return fn


def make_tp_prefill_slot_chunk(mesh, cfg: ModelConfig, *, mode: str,
                               fuse: bool = False):
    """One prompt chunk into one cache slot on the mesh: (params, k, v,
    tokens [T], slot (global), start_pos, last_pos) -> (logits [V], k, v);
    runtime.batched.mesh_prefill_slot_chunk (only the owner's dp shard
    writes the slot; its logits are broadcast over dp)."""
    loc = local_config(cfg, mesh.tp)

    def fn(params, k, v, tokens, slot, start_pos, last_pos):
        return mesh_prefill_slot_chunk(
            mesh, params, loc, k, v, tokens, slot, start_pos, last_pos,
            mode=mode, fuse=fuse, out_vocab=cfg.vocab_size)
    return fn


def make_tp_prefill_slots_chunk(mesh, cfg: ModelConfig, *, mode: str,
                                fuse: bool = False):
    """Batched admission on the mesh: (params, k, v, tokens [N][C], slots
    [N] (global), valid [N], start_pos, last_pos [N]) -> (logits [N, V],
    k, v); runtime.batched.mesh_prefill_slots_chunk (rows [d*M, (d+1)*M)
    go to dp shard d, padding rows' cache writes dropped)."""
    loc = local_config(cfg, mesh.tp)

    def fn(params, k, v, tokens, slots, valid, start_pos, last_pos):
        return mesh_prefill_slots_chunk(
            mesh, params, loc, k, v, tokens, slots, valid, start_pos,
            last_pos, mode=mode, fuse=fuse, out_vocab=cfg.vocab_size)
    return fn
