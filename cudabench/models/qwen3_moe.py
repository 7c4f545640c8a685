"""Qwen3-30B-A3B (HF `qwen3_moe`) as the benchmark makes, hands over and
counts it: the dense decoder's attention, norms and classifier
(models/qwen3.py, whose helpers it takes) with every layer's MLP a sparse
expert layer. The interface is models/qwen3.py's (`sizes_of`, `make`,
`to_port`, `counters`, `port_forward`, `port_cache`, `FAMILIES`).

The tensors: per layer wq, wk, wv, wo and the router wr [L, E, dim] as
stacked Q8_0 families (int8 with float32 scales over groups of
`group_size` along the input), each expert family a list of L per-layer
tensors, we1 and we3 [E, width, dim] and we2 [E, dim, width], the
embedding and the untied classifier [V, dim], the float32 norm weights.
The generator fills the stacked families, then the experts layer by
layer (we1, we2, we3), then the norms, all from the run's seed on the
card. The expert families go to the port as those tensors on the card
(models/qwen3.py::init_params packs w1 and w3 into w13 a layer at a time
and lets go of each layer it has packed), so the card holds at most the
model and one layer and the host never holds an expert.
"""

from __future__ import annotations

from pathlib import Path

from cudabench.core import weights
from cudabench.core.spec import load_module
from cudabench.metrics._roofline import Family

base = load_module(Path(__file__).with_name("qwen3.py"),
                   "cudabench_models_qwen3_moe_dense")
counters, port_cache, port_forward = (base.counters, base.port_cache,
                                      base.port_forward)
weight_bytes = base.weight_bytes
NORMS = base.NORMS
EXPERT_MATS = ("we1", "we2", "we3")


def sizes_of(config: dict) -> dict:
    """The model's sizes from a configuration file (its published keys)."""
    return {
        "dim": int(config["hidden_size"]),
        "n_layers": int(config["num_hidden_layers"]),
        "n_heads": int(config["num_attention_heads"]),
        "n_kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config["head_dim"]),
        "vocab_size": int(config["vocab_size"]),
        "tied": bool(config["tie_word_embeddings"]),
        "group_size": int(config["quantization"]["group_size"]),
        "rms_eps": float(config["rms_norm_eps"]),
        "rope_theta": float(config["rope_theta"]),
        "n_experts": int(config["num_experts"]),
        "experts_per_tok": int(config["num_experts_per_tok"]),
        "expert_dim": int(config["moe_intermediate_size"]),
    }


def shapes(s: dict) -> dict[str, tuple[int, ...]]:
    """Each stacked Q8_0 family's [..., out, in] shape, in fill order."""
    L, D = s["n_layers"], s["dim"]
    P, KV = s["n_heads"] * s["head_dim"], s["n_kv_heads"] * s["head_dim"]
    out = {"emb": (s["vocab_size"], D), "wq": (L, P, D), "wk": (L, KV, D),
           "wv": (L, KV, D), "wo": (L, D, P), "wr": (L, s["n_experts"], D)}
    if not s["tied"]:
        out["cls"] = (s["vocab_size"], D)
    return out


def expert_shapes(s: dict) -> dict[str, tuple[int, ...]]:
    """One layer's [E, out, in] of each expert family, in fill order."""
    E, D, F = s["n_experts"], s["dim"], s["expert_dim"]
    return {"we1": (E, F, D), "we2": (E, D, F), "we3": (E, F, D)}


def make(s: dict, seed: int, spec: dict, device) -> dict:
    """The Q8_0 tensors (`<name>_q` int8, `<name>_s` float32; the expert
    families as lists of per-layer tensors) and the norm weights, on
    `device`, from `seed`. `spec` is the configuration's "weights"."""
    scale, G = float(spec["scale"]), s["group_size"]
    gen = weights.generator(seed, device)
    w: dict = {}
    for name, shape in shapes(s).items():
        w[name + "_q"], w[name + "_s"] = weights.q8(shape, G, scale, gen,
                                                    device)
    for name in EXPERT_MATS:
        w[name + "_q"], w[name + "_s"] = [], []
    for _ in range(s["n_layers"]):
        for name, shape in expert_shapes(s).items():
            q, sc = weights.q8(shape, G, scale, gen, device)
            w[name + "_q"].append(q)
            w[name + "_s"].append(sc)
    for name, shape in base.norm_shapes(s).items():
        w[name] = weights.norm(shape, gen, device)
    if s["tied"]:
        w["cls_q"], w["cls_s"] = w["emb_q"], w["emb_s"]
    return w


def model_config(s: dict, seq_len: int):
    """The port's ModelConfig of these sizes (no dense MLP)."""
    from qwen3_tpu_torch.config import ModelConfig

    return ModelConfig(dim=s["dim"], hidden_dim=0, n_layers=s["n_layers"],
                       n_heads=s["n_heads"], n_kv_heads=s["n_kv_heads"],
                       vocab_size=s["vocab_size"], seq_len=seq_len,
                       head_dim=s["head_dim"], shared_classifier=s["tied"],
                       group_size=s["group_size"],
                       n_experts=s["n_experts"],
                       n_experts_per_tok=s["experts_per_tok"],
                       expert_dim=s["expert_dim"])


def to_port(w: dict, s: dict, seq_len: int, mode: str, device):
    """Hand the tensors to the port (models/qwen3.py::init_params): the
    stacked families and the norms as host arrays, the expert families as
    the lists of their tensors on the card, with no host copy. `w` is
    emptied first. Returns (ModelConfig, params)."""
    from qwen3_tpu_torch.io.checkpoint import Q8Weights
    from qwen3_tpu_torch.models.qwen3 import init_params

    cfg = model_config(s, seq_len)
    experts = {name + part: w.pop(name + part) for name in EXPERT_MATS
               for part in ("_q", "_s")}
    host = weights.to_host(w, device)
    fields = {k: host[k] for k in NORMS}
    for name in ("emb", "cls", "wq", "wk", "wv", "wo", "wr"):
        fields[name + "_q"], fields[name + "_s"] = (host[name + "_q"],
                                                    host[name + "_s"])
    del host
    params = init_params(Q8Weights(config=cfg, **fields, **experts),
                         mode=mode, max_seq_len=seq_len, device=device)
    return cfg, params


# -- the work of each kernel family --------------------------------------
#
# As models/qwen3.py's: a decode step's rows are the tokens it generated, a
# prefill's the prompt tokens, each input byte read once and each output
# byte written once. The expert layer's weights are counted once a decode
# step and once a prefill forward, all of them: a step of 64 slots routes
# 512 (row, expert) pairs, which reach 1 - (120/128)^64 = 98.4% of a
# layer's experts in expectation under even routing (the random weights
# route almost evenly), so the count is at most 1.6% above what such a
# step reads; a prefill forward of ~300 rows reaches all but 1e-8 of them.

# the expert kernels (ops/cuda/moe.py, csrc/moe_experts.cu), and the
# routing's (csrc/moe_route.cu)
EXPERT_KERNELS = ("q8_fast_group_kernel",)
ROUTING_KERNELS = ("moe_route_kernel", "moe_index_kernel",
                   "moe_combine_kernel")


def layer_mats(s: dict) -> list[tuple[int, int]]:
    """(in, out) of a layer's dense matmuls as the port runs them: qkv,
    wo."""
    P = s["n_heads"] * s["head_dim"]
    KV = s["n_kv_heads"] * s["head_dim"]
    return [(s["dim"], P + 2 * KV), (P, s["dim"])]


def matmul_work(s: dict, decode_tokens: int, steps: int, prompt_tokens: int,
                admitted: int, forwards: int) -> tuple[float, float]:
    """(operations, bytes) of the dense matmul kernels (attention's
    projections and the classifier; models/qwen3.py::matmul_work's rules:
    bf16 activations in, float32 out, the classifier on each admitted
    prompt's last row)."""
    G, L = s["group_size"], s["n_layers"]
    mats = layer_mats(s)
    w_layers = L * sum(weight_bytes(i, o, G) for i, o in mats)
    w_cls = weight_bytes(s["dim"], s["vocab_size"], G)
    a_layers = L * sum(2 * i + 4 * o for i, o in mats)
    a_cls = 2 * s["dim"] + 4 * s["vocab_size"]
    p_layers = L * sum(i * o for i, o in mats)
    p_cls = s["dim"] * s["vocab_size"]
    flops = (2 * p_layers * (decode_tokens + prompt_tokens)
             + 2 * p_cls * (decode_tokens + admitted))
    nbytes = ((steps + forwards) * (w_layers + w_cls)
              + (decode_tokens + prompt_tokens) * a_layers
              + (decode_tokens + admitted) * a_cls)
    return float(flops), float(nbytes)


def expert_flops(s: dict, tokens: int) -> float:
    """2 x 3 x dim x width x experts_per_tok a token a layer."""
    return float(2 * 3 * s["dim"] * s["expert_dim"] * s["experts_per_tok"]
                 * s["n_layers"] * tokens)


def expert_work(s: dict, tokens: int, passes: int) -> tuple[float, float]:
    """(operations, bytes) of the grouped expert kernels for `tokens` rows
    over `passes` decode steps and prefill forwards: every expert's w13
    and w2 once a pass; a row's f32 input once, and for each of its pairs
    the bf16 swiglu written and read and the f32 w2 output written."""
    D, F, K, L = (s["dim"], s["expert_dim"], s["experts_per_tok"],
                  s["n_layers"])
    G = s["group_size"]
    w_layer = s["n_experts"] * (weight_bytes(D, 2 * F, G)
                                + weight_bytes(F, D, G))
    a_row = 4 * D + K * (2 * F + 2 * F + 4 * D)
    return (expert_flops(s, tokens),
            float(passes * L * w_layer + tokens * L * a_row))


def routing_flops(s: dict, tokens: int) -> float:
    """The router's 2 x dim x experts a token a layer."""
    return float(2 * s["dim"] * s["n_experts"] * s["n_layers"] * tokens)


def routing_work(s: dict, tokens: int, passes: int) -> tuple[float, float]:
    """(operations, bytes) of the routing kernels: the router's weights
    once a pass; a row's f32 input, its ids and weights written, the ids
    read by the index and each entry's index written, then the combine's
    read of its pairs' f32 outputs and weights and its f32 row written."""
    D, K, L = s["dim"], s["experts_per_tok"], s["n_layers"]
    w_layer = weight_bytes(D, s["n_experts"], s["group_size"])
    a_row = 4 * D + 8 * K + 4 * K + 4 * K + 4 * K * D + 4 * K + 4 * D
    return (routing_flops(s, tokens),
            float(passes * L * w_layer + tokens * L * a_row))


def _tokens(positions, admitted):
    return len(positions) + sum(admitted)


FAMILIES = {
    "matmul": Family(
        kernels=base.MATMUL_KERNELS,
        work=lambda s, positions, admitted, steps, forwards: matmul_work(
            s, len(positions), steps, sum(admitted), len(admitted),
            forwards),
        flops=lambda s, positions, admitted: matmul_work(
            s, len(positions), 0, sum(admitted), len(admitted), 0)[0]),
    "attention": base.FAMILIES["attention"],
    "experts": Family(
        kernels=EXPERT_KERNELS,
        work=lambda s, positions, admitted, steps, forwards: expert_work(
            s, _tokens(positions, admitted), steps + forwards),
        flops=lambda s, positions, admitted: expert_flops(
            s, _tokens(positions, admitted))),
    "routing": Family(
        kernels=ROUTING_KERNELS,
        work=lambda s, positions, admitted, steps, forwards: routing_work(
            s, _tokens(positions, admitted), steps + forwards),
        flops=lambda s, positions, admitted: routing_flops(
            s, _tokens(positions, admitted))),
}
