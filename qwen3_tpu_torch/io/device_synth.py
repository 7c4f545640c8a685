"""Device-side synthetic parameter generation.

The counterpart of qwen3_tpu/io/device_synth.py: the parameter dict of
`models.qwen3.load_params(path, mode="pallas")` (the same keys, shapes,
dtypes and device), generated on the device from a seeded
`torch.Generator` instead of read from a checkpoint, so that a probe or a
benchmark of a multi-GB model spends no time writing, reading and copying
random bytes. Speed does not depend on the weight values. The magnitudes
are the JAX package's: int8 weights in [-127, 127], scales
(scale / 127) * (0.5 + U[0, 1)), norm weights 1 + 0.1 N(0, 1). The values
themselves differ from the JAX package's: `jax.random` and
`torch.Generator` give different numbers from one seed.

The layout is the port's row-major one (wqkv_q [L, P + 2 KVD, dim], w13_q
[L, 2 hidden, dim], wo_q [L, dim, P], w2_q [L, dim, hidden], cls_q [V, dim],
each with `_s` f32 group scales [..., n/G]), not the JAX package's
[L, J, n, td] tiles. A tied classifier is the embedding tensors themselves,
as load_params makes it.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.models.qwen3 import resolve_device
from qwen3_tpu_torch.ops.rope import rope_tables


def packed_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """Shapes and dtypes of load_params(mode="pallas")'s dict, without the
    rope tables: the fused wqkv and w13 and the other Q8_0 tensors in
    row-major [..., out, in] (+ group scales), the norms and the
    embedding; cls_q/cls_s as the embedding's when the classifier is
    tied."""
    L, D, G = cfg.n_layers, cfg.dim, cfg.group_size

    def q8(lead: tuple[int, ...], out: int, n: int):
        return (lead + (out, n), "int8"), (lead + (out, n // G), "float32")

    s: dict[str, tuple[tuple[int, ...], str]] = {
        "att_norm": ((L, D), "float32"),
        "ffn_norm": ((L, D), "float32"),
        "out_norm": ((D,), "float32"),
        "q_norm": ((L, cfg.head_dim), "float32"),
        "k_norm": ((L, cfg.head_dim), "float32"),
    }
    s["emb_q"], s["emb_s"] = q8((), cfg.vocab_size, D)
    s["wqkv_q"], s["wqkv_s"] = q8((L,), cfg.proj_dim + 2 * cfg.kv_dim, D)
    s["w13_q"], s["w13_s"] = q8((L,), 2 * cfg.hidden_dim, D)
    s["wo_q"], s["wo_s"] = q8((L,), D, cfg.proj_dim)
    s["w2_q"], s["w2_s"] = q8((L,), D, cfg.hidden_dim)
    s["cls_q"], s["cls_s"] = q8((), cfg.vocab_size, D)
    return s


def synth_device_params(cfg: ModelConfig, max_seq_len: int, *, seed: int = 0,
                        scale: float = 0.02, device="cuda",
                        exec_cache: str | None = None) -> dict:
    """Generate the pallas-mode parameter dict on `device` (default the
    card; "cuda" without one raises), leaf by leaf in sorted key order from
    one generator seeded with `seed`, plus rope tables for `max_seq_len`
    positions. `exec_cache`, the JAX package's directory of compiled TPU
    executables, has no counterpart here and is refused."""
    if exec_cache is not None:
        raise NotImplementedError(
            "exec_cache (the TPU's compiled-executable cache) is not ported")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = packed_shapes(cfg)
    tied = cfg.shared_classifier
    p = {}
    for name in sorted(shapes):
        if tied and name.startswith("cls_"):
            continue
        shape, dt = shapes[name]
        if dt == "int8":
            v = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                              generator=gen)
        elif name.endswith("_s"):
            v = (scale / 127.0) * (0.5 + torch.rand(shape, device=dev,
                                                    generator=gen))
        else:   # norm weights
            v = 1.0 + 0.1 * torch.randn(shape, device=dev, generator=gen)
        p[name] = v
    if tied:
        p["cls_q"], p["cls_s"] = p["emb_q"], p["emb_s"]
    p["rope_cos"], p["rope_sin"] = rope_tables(cfg.head_dim, max_seq_len,
                                               device=dev)
    return p
