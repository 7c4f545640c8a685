"""The benchmark's own inputs of the model: Q8_0 weights made from the
seed on the device, and their hand-over to the port.

The tensors are the checkpoint format's (qwen3.c's export): per layer
wq, wk, wv, wo, w1, w2, w3 as int8 [L, out, in] with float32 scales over
groups of `group_size` along `in`, the embedding [V, dim] (and an untied
classifier), and the float32 norm weights. One seeded torch.Generator on
the card fills each tensor family in one call, in a fixed order, so the
same seed gives the same bytes, and the reference makes them again after
the program has gone. Their magnitudes are the port's synthetic ones:
int8 in [-127, 127], scales (scale / 127) * (0.5 + U[0, 1)), norm weights
1 + 0.1 N(0, 1).
"""

from __future__ import annotations

import torch

# the checkpoint's tensors in the order the generator fills them
LAYER_MATS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


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
    """Each Q8_0 tensor's [..., out, in] shape."""
    L, D, H = s["n_layers"], s["dim"], s["hidden_dim"]
    P, KV = s["n_heads"] * s["head_dim"], s["n_kv_heads"] * s["head_dim"]
    out = {"emb": (s["vocab_size"], D),
           "wq": (L, P, D), "wk": (L, KV, D), "wv": (L, KV, D),
           "wo": (L, D, P), "w1": (L, H, D), "w2": (L, D, H),
           "w3": (L, H, D)}
    if not s["tied"]:
        out["cls"] = (s["vocab_size"], D)
    return out


def make(s: dict, seed: int, spec: dict, device) -> dict[str, torch.Tensor]:
    """The Q8_0 tensors (`<name>_q` int8, `<name>_s` float32) and the
    norm weights, on `device`, from `seed`. `spec` is the configuration's
    "weights": its `scale`."""
    scale = float(spec["scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    G, L, D = s["group_size"], s["n_layers"], s["dim"]
    w: dict[str, torch.Tensor] = {}
    for name, shape in shapes(s).items():
        w[name + "_q"] = torch.randint(-127, 128, shape, dtype=torch.int8,
                                       device=device, generator=gen)
        w[name + "_s"] = (scale / 127.0) * (0.5 + torch.rand(
            shape[:-1] + (shape[-1] // G,), device=device, generator=gen))
    for name, shape in (("att_norm", (L, D)), ("ffn_norm", (L, D)),
                        ("out_norm", (D,)), ("q_norm", (L, s["head_dim"])),
                        ("k_norm", (L, s["head_dim"]))):
        w[name] = 1.0 + 0.1 * torch.randn(shape, device=device,
                                          generator=gen)
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
    for `mode`); `w` is emptied, so that its device copies are freed
    before the port's are made. Returns (ModelConfig, params)."""
    from qwen3_tpu_torch.io.checkpoint import Q8Weights
    from qwen3_tpu_torch.models.qwen3 import init_params

    cfg = model_config(s, seq_len)
    host, seen = {}, {}
    for key in list(w):
        t = w.pop(key)
        if id(t) not in seen:     # a tied classifier is the embedding
            seen[id(t)] = t.cpu().numpy()
        host[key] = seen[id(t)]
        del t
    seen.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fields = {k: host[k] for k in ("att_norm", "ffn_norm", "out_norm",
                                   "q_norm", "k_norm", "emb_q", "emb_s",
                                   "cls_q", "cls_s")}
    for name in LAYER_MATS:
        fields[name + "_q"], fields[name + "_s"] = (host[name + "_q"],
                                                    host[name + "_s"])
    params = init_params(Q8Weights(config=cfg, **fields), mode=mode,
                         max_seq_len=seq_len, device=device)
    return cfg, params
