"""A test-only model, added to a copy of the benchmark as files alone
(tests/tiny.py W13_FILES): the dense block with w1 and w3 made as one
stacked Q8_0 family `w13` [L, 2 * hidden, dim], which its hand-over splits
into the port's w1 and w3 and its reference (reference/tiny_w13.py) reads
whole. Its sizes, counters and work counts are the dense block's."""

from __future__ import annotations

from pathlib import Path

from cudabench.core import weights
from cudabench.core.spec import load_module

base = load_module(Path(__file__).with_name("qwen3.py"), "tiny_w13_base")
sizes_of, counters = base.sizes_of, base.counters
port_cache, port_forward = base.port_cache, base.port_forward
FAMILIES = base.FAMILIES


def shapes(s: dict) -> dict:
    out = base.shapes(s)
    L, H, D = out.pop("w1")
    del out["w3"]
    out["w13"] = (L, 2 * H, D)
    return out


def make(s: dict, seed: int, spec: dict, device) -> dict:
    gen = weights.generator(seed, device)
    w = {}
    for name, shape in shapes(s).items():
        w[name + "_q"], w[name + "_s"] = weights.q8(
            shape, s["group_size"], float(spec["scale"]), gen, device)
    for name, shape in base.norm_shapes(s).items():
        w[name] = weights.norm(shape, gen, device)
    if s["tied"]:
        w["cls_q"], w["cls_s"] = w["emb_q"], w["emb_s"]
    return w


def to_port(w: dict, s: dict, seq_len: int, mode: str, device):
    H = s["hidden_dim"]
    for part in ("_q", "_s"):
        w13 = w.pop("w13" + part)
        w["w1" + part] = w13[:, :H].contiguous()
        w["w3" + part] = w13[:, H:].contiguous()
        del w13
    return base.to_port(w, s, seq_len, mode, device)
