"""The dense Qwen3 decoder as the benchmark makes, hands over and counts it.

A configuration names its model module by its key "model"; the harness
finds it as models/<model>.py and uses only what follows, so that a model
with other tensors adds a module of its own and edits none:

- `sizes_of(config)`: the model's sizes from the configuration's keys
  (`run.sizes`);
- `make(sizes, seed, spec, device)`: its tensors from the seed, on the
  device (core/weights.py fills them), which the reference of the same
  configuration reads;
- `to_port(w, sizes, seq_len, mode, device)`: their hand-over to the port,
  which returns (the port's ModelConfig, its parameters);
- `counters()`: the port's count of forwards ("decode_forward" for decode
  steps, "forward" for prefill block forwards), which names the loop's
  bursts and the traced sub-window's ends;
- `port_forward`, `port_cache`: the port's own forward over a block of one
  sequence, for cudabench/control.py's control in the program's lower
  precision;
- `FAMILIES`: the work of each kernel family (metrics/_roofline.py
  `Family`) that the rooflines and the step's MFU read.

The tensors are the checkpoint format's (qwen3.c's export): per layer
wq, wk, wv, wo, w1, w2, w3 as int8 [L, out, in] with float32 scales over
groups of `group_size` along `in`, the embedding [V, dim] (and an untied
classifier), and the float32 norm weights.
"""

from __future__ import annotations

import torch

from cudabench.core import weights
from cudabench.metrics._roofline import Family

# the checkpoint's layer matrices, in the order the generator fills them
LAYER_MATS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
NORMS = ("att_norm", "ffn_norm", "out_norm", "q_norm", "k_norm")


def sizes_of(config: dict) -> dict:
    """The model's sizes from a configuration file (its published keys)."""
    return {
        "dim": int(config["hidden_size"]),
        "hidden_dim": int(config["intermediate_size"]),
        "n_layers": int(config["num_hidden_layers"]),
        "n_heads": int(config["num_attention_heads"]),
        "n_kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config["head_dim"]),
        "vocab_size": int(config["vocab_size"]),
        "tied": bool(config["tie_word_embeddings"]),
        "group_size": int(config["quantization"]["group_size"]),
        "rms_eps": float(config["rms_norm_eps"]),
        "rope_theta": float(config["rope_theta"]),
    }


def shapes(s: dict) -> dict[str, tuple[int, ...]]:
    """Each Q8_0 tensor's [..., out, in] shape, in the generator's order."""
    L, D, H = s["n_layers"], s["dim"], s["hidden_dim"]
    P, KV = s["n_heads"] * s["head_dim"], s["n_kv_heads"] * s["head_dim"]
    out = {"emb": (s["vocab_size"], D),
           "wq": (L, P, D), "wk": (L, KV, D), "wv": (L, KV, D),
           "wo": (L, D, P), "w1": (L, H, D), "w2": (L, D, H),
           "w3": (L, H, D)}
    if not s["tied"]:
        out["cls"] = (s["vocab_size"], D)
    return out


def norm_shapes(s: dict) -> dict[str, tuple[int, ...]]:
    """Each norm weight's shape, in the generator's order (after the
    Q8_0 tensors)."""
    L, D, Dh = s["n_layers"], s["dim"], s["head_dim"]
    return dict(zip(NORMS, ((L, D), (L, D), (D,), (L, Dh), (L, Dh))))


def make(s: dict, seed: int, spec: dict, device) -> dict[str, torch.Tensor]:
    """The Q8_0 tensors (`<name>_q` int8, `<name>_s` float32) and the
    norm weights, on `device`, from `seed`. `spec` is the configuration's
    "weights": its `scale`."""
    scale = float(spec["scale"])
    gen = weights.generator(seed, device)
    w: dict[str, torch.Tensor] = {}
    for name, shape in shapes(s).items():
        w[name + "_q"], w[name + "_s"] = weights.q8(
            shape, s["group_size"], scale, gen, device)
    for name, shape in norm_shapes(s).items():
        w[name] = weights.norm(shape, gen, device)
    if s["tied"]:
        w["cls_q"], w["cls_s"] = w["emb_q"], w["emb_s"]
    return w


def model_config(s: dict, seq_len: int):
    """The port's ModelConfig of these sizes."""
    from qwen3_tpu_torch.config import ModelConfig

    return ModelConfig(dim=s["dim"], hidden_dim=s["hidden_dim"],
                       n_layers=s["n_layers"], n_heads=s["n_heads"],
                       n_kv_heads=s["n_kv_heads"],
                       vocab_size=s["vocab_size"], seq_len=seq_len,
                       head_dim=s["head_dim"], shared_classifier=s["tied"],
                       group_size=s["group_size"])


def to_port(w: dict[str, torch.Tensor], s: dict, seq_len: int, mode: str,
            device):
    """Hand the tensors to the port through its public entry
    (models/qwen3.py::init_params, which takes host arrays and packs them
    for `mode`); `w` is emptied first (core/weights.py to_host). Returns
    (ModelConfig, params)."""
    from qwen3_tpu_torch.io.checkpoint import Q8Weights
    from qwen3_tpu_torch.models.qwen3 import init_params

    cfg = model_config(s, seq_len)
    host = weights.to_host(w, device)
    fields = {k: host[k] for k in NORMS + ("emb_q", "emb_s", "cls_q",
                                           "cls_s")}
    for name in LAYER_MATS:
        fields[name + "_q"], fields[name + "_s"] = (host[name + "_q"],
                                                    host[name + "_s"])
    params = init_params(Q8Weights(config=cfg, **fields), mode=mode,
                         max_seq_len=seq_len, device=device)
    return cfg, params


def counters() -> dict:
    """The port's counts of its forwards by kind (models/qwen3.py CALLS),
    the live dict."""
    from qwen3_tpu_torch.models.qwen3 import CALLS

    return CALLS


def port_cache(cfg, rows: int, device):
    """An int8 KV cache of the port for one sequence of `rows`."""
    from qwen3_tpu_torch.models.qwen3 import init_kv_cache

    return init_kv_cache(cfg, 1, rows, "int8", device)


def port_forward(params, cfg, ids: torch.Tensor, k, v, offset: int,
                 mode: str):
    """The port's forward in `mode` over the block `ids` [1, T] of one
    sequence from position `offset`: (logits of every row, k, v)."""
    from qwen3_tpu_torch.models.qwen3 import forward

    return forward(params, cfg, ids, k, v, offset, mode=mode,
                   all_logits=True)


# -- the work of each kernel family --------------------------------------
#
# Work is what these inputs need: a decode step's rows are the tokens it
# generated (not the frozen or empty slots it also ran), a prefill's rows
# the prompt tokens (not a block's padding), each input byte read once and
# each output byte written once.

# the port's Q8_0 matmuls of every mode, by their kernels' short names
MATMUL_KERNELS = (
    "q8_fast_tile_kernel", "q8_fast_split_kernel", "q8_fast_prologue_kernel",
    "q8q8_gemv_kernel", "q8q8_mma_kernel", "q8q8_split_sum_kernel",
    "q8q8_prologue_kernel", "q8i8_quantize_kernel", "q8i8_mma_kernel")
# the batched decode kernel (ops/cuda/batched_decode.py,
# csrc/decode_partial.cuh)
ATTENTION_KERNELS = ("decode_kernel",)


def layer_mats(s: dict) -> list[tuple[int, int]]:
    """(in, out) of one layer's matmuls as the port runs them: qkv, wo,
    w1 and w3 together, w2."""
    P = s["n_heads"] * s["head_dim"]
    KV = s["n_kv_heads"] * s["head_dim"]
    return [(s["dim"], P + 2 * KV), (P, s["dim"]),
            (s["dim"], 2 * s["hidden_dim"]), (s["hidden_dim"], s["dim"])]


def weight_bytes(n_in: int, n_out: int, group: int) -> int:
    """Q8_0: one int8 a weight, one float32 scale a group."""
    return n_in * n_out + 4 * n_out * (n_in // group)


def matmul_params(s: dict) -> tuple[int, int]:
    """(parameters of every layer's matmuls, of the classifier)."""
    layers = s["n_layers"] * sum(i * o for i, o in layer_mats(s))
    return layers, s["dim"] * s["vocab_size"]


def matmul_work(s: dict, decode_tokens: int, steps: int,
                prompt_tokens: int, admitted: int,
                forwards: int) -> tuple[float, float]:
    """(operations, bytes) of the matmul kernels for `decode_tokens`
    generated over `steps` decode steps and `prompt_tokens` prefilled
    for `admitted` requests over `forwards` block forwards. Every step
    and every block forward reads all weights once; the classifier of a
    prefill runs on each request's last prompt row only. Activations:
    bf16 in, float32 out."""
    G = s["group_size"]
    mats = layer_mats(s)
    w_layers = s["n_layers"] * sum(weight_bytes(i, o, G) for i, o in mats)
    w_cls = weight_bytes(s["dim"], s["vocab_size"], G)
    a_layers = s["n_layers"] * sum(2 * i + 4 * o for i, o in mats)
    a_cls = 2 * s["dim"] + 4 * s["vocab_size"]
    p_layers, p_cls = matmul_params(s)
    flops = (2 * p_layers * (decode_tokens + prompt_tokens)
             + 2 * p_cls * (decode_tokens + admitted))
    nbytes = ((steps + forwards) * (w_layers + w_cls)
              + (decode_tokens + prompt_tokens) * a_layers
              + (decode_tokens + admitted) * a_cls)
    return float(flops), float(nbytes)


def decode_attention_work(s: dict,
                          positions: list[int]) -> tuple[float, float]:
    """(operations, bytes) of decode attention for one token fed at each
    of `positions`: every layer reads the int8 K and V rows and their
    float32 scales of positions 0..p once, its query (bf16) and writes its
    partial output (float32 values, max and sum); two products a row a
    head element (scores, then values)."""
    H, KV, D, L = (s["n_heads"], s["n_kv_heads"], s["head_dim"],
                   s["n_layers"])
    rows = sum(p + 1 for p in positions)
    flops = 4 * H * D * L * rows
    nbytes = L * (rows * 2 * KV * (D + 4)
                  + len(positions) * (2 * H * D + 4 * H * (D + 2)))
    return float(flops), float(nbytes)


def prefill_attention_flops(s: dict, lengths: list[int]) -> float:
    """Causal attention's products over whole prompts of `lengths`."""
    H, D, L = s["n_heads"], s["head_dim"], s["n_layers"]
    return float(sum(4 * H * D * L * n * (n + 1) // 2 for n in lengths))


def _matmul(s, positions, admitted, steps=0, forwards=0):
    return matmul_work(s, len(positions), steps, sum(admitted),
                       len(admitted), forwards)


FAMILIES = {
    "matmul": Family(
        kernels=MATMUL_KERNELS, work=_matmul,
        flops=lambda s, positions, admitted: _matmul(s, positions,
                                                     admitted)[0]),
    "attention": Family(
        kernels=ATTENTION_KERNELS,
        work=lambda s, positions, admitted, steps, forwards:
            decode_attention_work(s, positions),
        flops=lambda s, positions, admitted: (
            decode_attention_work(s, positions)[0]
            + prefill_attention_flops(s, admitted))),
}
