"""HuggingFace -> binary export pipeline, the counterpart of
qwen3_tpu/io/hf_export.py (the same output bytes).

Converts a Qwen3ForCausalLM checkpoint directory into the engine's two
artifacts, with the same output bytes as the reference exporter
(qwen3/weights.py, qwen3/tokenizer.py) on well-formed checkpoints, and a
Qwen3MoeForCausalLM one (`model_type` "qwen3_moe", Qwen3-30B-A3B) into the
version-2 `.bin` (io/checkpoint.py): its router `mlp.gate` and each
expert's `mlp.experts.{e}.gate_proj/up_proj/down_proj`, quantized as every
other matrix:

- `<out>.bin`: 256-byte header + fp32 norms + Q8_0 tensors. Quantization
  mirrors the exporter: per-group absmax scale wmax/127, round-half-to-even
  (torch.round semantics), groups of `group_size` halved until dim divides
  (qwen3/weights.py:202-208), tied classifier detected by exact tensor
  equality (qwen3/weights.py:230-238). Deviation: a 1e-6 zero-scale guard is
  added (the reference exporter divides by zero on an all-zero group,
  qwen3/weights.py:156-160; the runtime quantizer guards, src/q8.c:19-20).
- `<out>.tokenizer`: v2 layout with 10 special ids. Token bytes via the
  inverse GPT-2 byte<->unicode map (unmapped codepoints dropped, mirroring
  qwen3/tokenizer.py:232-244), merge-rank pseudo-scores -log(rank+1), base
  tokens -1e6, vocab padded to config vocab_size with <|pad_N|>; the header
  max_len records the *unicode* string length like the reference
  (qwen3/tokenizer.py:201).

transformers (and safetensors under it) import lazily, so the inference
engine never needs them.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.io.checkpoint import Q8Weights, write_checkpoint
from qwen3_tpu_torch.io.tokenizer_bin import (
    SpecialTokens,
    TokenizerData,
    write_tokenizer_bin,
)

# -- weights ------------------------------------------------------------------


def _load_state_dict(hf_dir: str) -> dict:
    import torch
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(hf_dir,
                                                 torch_dtype=torch.float32)
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def read_hf_config(hf_dir: str) -> dict:
    with open(os.path.join(hf_dir, "config.json")) as f:
        return json.load(f)


def _quantize(w: np.ndarray, gs: int) -> tuple[np.ndarray, np.ndarray]:
    flat = np.asarray(w, np.float32).reshape(-1, gs)
    wmax = np.abs(flat).max(axis=1)
    scale = np.where(wmax == 0.0, np.float32(1e-6),
                     wmax / np.float32(127.0)).astype(np.float32)
    q = np.rint(flat / scale[:, None])  # half-to-even = torch.round
    q = np.clip(q, -127, 127).astype(np.int8)
    return q.reshape(w.shape), scale


def export_model(hf_dir: str, out_path: str, group_size: int = 64) -> ModelConfig:
    return export_state(_load_state_dict(hf_dir), read_hf_config(hf_dir),
                        out_path, group_size)


def export_state(state: dict, cfg_json: dict, out_path: str,
                 group_size: int = 64) -> ModelConfig:
    """export_model's body on a state dict of float arrays (HF names) and
    its config.json's dict."""
    dim = cfg_json.get("hidden_size", 2048)
    n_layers = cfg_json.get("num_hidden_layers", 28)
    n_heads = cfg_json.get("num_attention_heads", 16)
    n_kv_heads = cfg_json.get("num_key_value_heads", 8)
    vocab = cfg_json.get("vocab_size", 151936)
    hidden = cfg_json.get("intermediate_size", 6144)
    max_seq = cfg_json.get("max_position_embeddings", 40960)
    head_dim = cfg_json.get("head_dim", dim // n_heads)

    moe = cfg_json.get("model_type") == "qwen3_moe"
    experts = {}
    if moe:
        if cfg_json.get("mlp_only_layers") or cfg_json.get(
                "decoder_sparse_step", 1) != 1:
            raise NotImplementedError(
                "a qwen3_moe model with dense layers is not ported")
        hidden = 0
        experts = dict(n_experts=cfg_json["num_experts"],
                       n_experts_per_tok=cfg_json["num_experts_per_tok"],
                       expert_dim=cfg_json["moe_intermediate_size"])

    while dim % group_size != 0:
        group_size //= 2
        print(f"[export] reducing group size to {group_size} to fit dim")

    L = n_layers

    def lay(i, name):
        return state[f"model.layers.{i}.{name}"]

    emb = state["model.embed_tokens.weight"]
    lm_head = state.get("lm_head.weight", emb)
    shared = np.array_equal(emb, lm_head)

    cfg = ModelConfig(dim=dim, hidden_dim=hidden, n_layers=L, n_heads=n_heads,
                      n_kv_heads=n_kv_heads, vocab_size=vocab, seq_len=max_seq,
                      head_dim=head_dim, shared_classifier=bool(shared),
                      group_size=group_size, **experts)
    cfg.validate()

    def stack_q8(names: list[np.ndarray]):
        qs, ss = [], []
        for w in names:
            q, s = _quantize(w, group_size)
            qs.append(q)
            ss.append(s.reshape(q.shape[0], -1))
        return np.stack(qs), np.stack(ss)

    emb_q, emb_s = _quantize(emb, group_size)
    emb_s = emb_s.reshape(vocab, -1)
    wq = stack_q8([lay(i, "self_attn.q_proj.weight") for i in range(L)])
    wk = stack_q8([lay(i, "self_attn.k_proj.weight") for i in range(L)])
    wv = stack_q8([lay(i, "self_attn.v_proj.weight") for i in range(L)])
    wo = stack_q8([lay(i, "self_attn.o_proj.weight") for i in range(L)])
    mlp = {}
    if moe:
        E = cfg.n_experts

        def per_layer(name):
            """One expert matrix [E, out, in] a layer, as lists."""
            qs, ss = [], []
            for i in range(L):
                q, s = stack_q8([lay(i, f"mlp.experts.{e}.{name}.weight")
                                 for e in range(E)])
                qs.append(q)
                ss.append(s)
            return qs, ss

        mlp["wr_q"], mlp["wr_s"] = stack_q8(
            [lay(i, "mlp.gate.weight") for i in range(L)])
        mlp["wr_s"] = mlp["wr_s"].reshape(L, E, -1)
        for ours, theirs in (("we1", "gate_proj"), ("we2", "down_proj"),
                             ("we3", "up_proj")):
            mlp[ours + "_q"], mlp[ours + "_s"] = per_layer(theirs)
    else:
        for ours, theirs in (("w1", "gate_proj"), ("w2", "down_proj"),
                             ("w3", "up_proj")):
            q, s = stack_q8([lay(i, f"mlp.{theirs}.weight")
                             for i in range(L)])
            mlp[ours + "_q"], mlp[ours + "_s"] = q, s
    if shared:
        cls_q, cls_s = emb_q, emb_s
    else:
        cls_q, cls_s = _quantize(lm_head, group_size)
        cls_s = cls_s.reshape(vocab, -1)

    weights = Q8Weights(
        config=cfg,
        att_norm=np.stack([lay(i, "input_layernorm.weight")
                           for i in range(L)]).astype(np.float32),
        ffn_norm=np.stack([lay(i, "post_attention_layernorm.weight")
                           for i in range(L)]).astype(np.float32),
        out_norm=state["model.norm.weight"].astype(np.float32),
        q_norm=np.stack([lay(i, "self_attn.q_norm.weight")
                         for i in range(L)]).astype(np.float32),
        k_norm=np.stack([lay(i, "self_attn.k_norm.weight")
                         for i in range(L)]).astype(np.float32),
        emb_q=emb_q, emb_s=emb_s,
        wq_q=wq[0], wq_s=wq[1], wk_q=wk[0], wk_s=wk[1],
        wv_q=wv[0], wv_s=wv[1], wo_q=wo[0], wo_s=wo[1],
        cls_q=cls_q, cls_s=cls_s, **mlp,
    )
    write_checkpoint(out_path, weights)
    print(f"[export] wrote {out_path}")
    return cfg


# -- tokenizer ----------------------------------------------------------------


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte -> unicode map (qwen3/tokenizer.py:217-229 semantics)."""
    base = list(range(ord("!"), ord("~") + 1))
    base += list(range(ord("¡"), ord("¬") + 1))
    base += list(range(ord("®"), ord("ÿ") + 1))
    codepoints = base[:]
    offset = 0
    for char in range(256):
        if char not in base:
            base.append(char)
            codepoints.append(256 + offset)
            offset += 1
    return dict(zip(base, map(chr, codepoints)))


_UNICODE_TO_BYTE = {t: i for i, t in bytes_to_unicode().items()}


def token_to_bytes(token: str) -> bytes:
    """Invert the byte-level encoding; unmapped codepoints are dropped
    (bug-for-bug with qwen3/tokenizer.py:232-244)."""
    return bytes(_UNICODE_TO_BYTE[c] for c in token if c in _UNICODE_TO_BYTE)


_SPECIAL_MAP = {
    "<|endoftext|>": "bos", "<|im_end|>": "eos", "<|im_start|>": "eot",
    "<think>": "bor", "</think>": "eor",
    "<tool_call>": "btc", "</tool_call>": "etc",
    "<tool_response>": "btr", "</tool_response>": "etr",
}

_SPECIAL_DEFAULTS = dict(bos=151643, eos=151645, eot=151644, pad=151643,
                         bor=151667, eor=151668, btc=151657, etc=151658,
                         btr=151665, etr=151666)


def export_tokenizer(hf_dir: str, out_prefix: str) -> TokenizerData:
    with open(os.path.join(hf_dir, "tokenizer.json"), encoding="utf-8") as f:
        tk = json.load(f)
    cfg = read_hf_config(hf_dir)

    vocab_map: dict[str, int] = tk["model"]["vocab"]
    id_to_token = {v: k for k, v in vocab_map.items()}
    for added in tk.get("added_tokens", []):
        id_to_token.setdefault(added["id"], added["content"])
    tokens = [id_to_token[i] for i in sorted(id_to_token)]

    vocab_size = cfg.get("vocab_size", 151936)
    start = len(tokens)
    for i in range(max(0, vocab_size - start)):
        tokens.append(f"<|pad_{start + i}|>")

    # merge-rank pseudo-scores
    rank_table: dict[str, int] = {}
    for rank, merge in enumerate(tk["model"]["merges"]):
        pair = tuple(merge if isinstance(merge, list) else merge.split())
        rank_table.setdefault("".join(pair), rank)
    scores = [(-math.log(r + 1) if (r := rank_table.get(t)) is not None
               else -1e6) for t in tokens]

    fields = dict(_SPECIAL_DEFAULTS)
    for added in tk.get("added_tokens", []):
        name = _SPECIAL_MAP.get(added["content"])
        if name:
            fields[name] = added["id"]
            if name == "bos":
                fields["pad"] = added["id"]
    special = SpecialTokens(**fields)

    max_len = max(len(t) for t in tokens)  # unicode length, like the reference
    data = TokenizerData(
        tokens=[token_to_bytes(t) for t in tokens],
        scores=[float(np.float32(s)) for s in scores],
        special=special, max_len=max_len)
    write_tokenizer_bin(out_prefix + ".tokenizer", data)
    print(f"[export] wrote {out_prefix}.tokenizer")
    return data


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="qwen3-tpu-torch-export",
        description="Export a HF Qwen3 checkpoint to .bin/.tokenizer")
    ap.add_argument("output_file")
    ap.add_argument("input_dir")
    ap.add_argument("-g", "--group-size", type=int, default=64)
    args = ap.parse_args(argv)
    export_tokenizer(args.input_dir, args.output_file)
    export_model(args.input_dir, args.output_file, args.group_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
