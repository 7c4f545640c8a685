"""Checkpoint load smoke check (reference examples/model.c:8-29), the
counterpart of qwen3_tpu/tools/model_check.py.

    python -m qwen3_tpu_torch.tools.model_check <model.bin> [seq_len]

Parses the .bin, prints the header params and per-tensor byte accounting,
and exits non-zero on any structural error.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m qwen3_tpu_torch.tools.model_check "
              "<model.bin> [seq_len]", file=sys.stderr)
        return 2
    path = argv[0]
    seq_len = int(argv[1]) if len(argv) > 1 else 0

    from qwen3_tpu_torch.config import has_experts
    from qwen3_tpu_torch.io.checkpoint import load_checkpoint

    try:
        w = load_checkpoint(path)
    except Exception as e:
        print(f"[model_check] FAILED to load {path}: {e}", file=sys.stderr)
        return 1
    cfg = w.config if not seq_len else w.config.with_seq_len(seq_len)
    print(f"[model_check] ok: {path}", file=sys.stderr)
    print(f"[Params] dim={cfg.dim} hidden={cfg.hidden_dim} "
          f"layers={cfg.n_layers} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.head_dim} vocab={cfg.vocab_size} "
          f"seq_len={cfg.seq_len} group_size={cfg.group_size} "
          f"tied={int(cfg.shared_classifier)}", file=sys.stderr)
    mlp = ("w1", "w2", "w3")
    if has_experts(cfg):
        print(f"[Experts] experts={cfg.n_experts} "
              f"per_token={cfg.n_experts_per_tok} width={cfg.expert_dim}",
              file=sys.stderr)
        mlp = ("wr", "we1", "we2", "we3")
    total = 0
    for name in ("emb", "wq", "wk", "wv", "wo", *mlp, "cls"):
        q = getattr(w, name + "_q")
        s = getattr(w, name + "_s")
        if isinstance(q, list):     # an expert family, a tensor a layer
            nbytes = sum(a.nbytes + b.nbytes for a, b in zip(q, s))
            qs, ss = ((len(q),) + q[0].shape, (len(s),) + s[0].shape)
        else:
            nbytes = q.nbytes + s.nbytes
            qs, ss = q.shape, s.shape
        total += nbytes
        print(f"[Weights] {name}: int8 {qs} + scales {ss} "
              f"= {nbytes / 1e6:.1f} MB", file=sys.stderr)
    print(f"[Weights] total {total / 1e6:.1f} MB", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
