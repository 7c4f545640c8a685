"""Quality-evidence table of the CUDA port: perplexity deltas of every
quantized execution path against the exact mode, at real context length, on
one checkpoint (qwen3_tpu/tools/quality_table.py's flags, gate and output,
plus --device).

    python -m qwen3_tpu_torch.tools.quality_table <model.bin> [-c 2048] \
        [--modes exact,pallas,pallas-fast,bf16] [--int8-kv] [--text FILE] \
        [--device cuda|cpu]

The criterion is delta ppl <= 0.05 against the exact mode (the reference C
integer pipeline, src/forward.c:88-97); in the synthetic regime (exact's
ppl > 100, random weights) the scale-free |delta ln ppl| <= 0.005 takes its
place. Emits one markdown table to stderr and one JSON line to stdout:

    {"metric": "delta_ppl", "ctx": N, "tokens": T, "rows": {...}, "pass": bool}

and exits 1 when a row misses the gate. Weight values do not decide kernel
numerics comparisons, so synthetic checkpoints are valid subjects;
deterministic pseudo-text keeps runs reproducible. QWEN3_TPU_FUSE=1 runs the
pallas modes' matmuls through the prologue-fused kernel, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import sys


def pseudo_text(n_bytes: int, seed: int = 7) -> str:
    """Deterministic mixed pseudo-text (words the byte-BPE merges on)."""
    import random

    rng = random.Random(seed)
    words = ["the", "thinker", "thought", "a", "in", "hat", "cat", "er",
             "on", "at", "and", "to", "of", "is", "it", "model", "token",
             "chip", "mesh", "kernel", "12", "345", "x", "."]
    out = []
    size = 0
    while size < n_bytes:
        w = rng.choice(words)
        out.append(w)
        size += len(w) + 1
    return " ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tpu_torch.tools.quality_table")
    ap.add_argument("checkpoint")
    ap.add_argument("-c", "--ctx", type=int, default=2048)
    ap.add_argument("--modes", default="exact,pallas,pallas-fast,bf16")
    ap.add_argument("--int8-kv", action="store_true", default=True,
                    help="also evaluate pallas + int8 KV cache (default on)")
    ap.add_argument("--no-int8-kv", dest="int8_kv", action="store_false")
    ap.add_argument("--text", default=None,
                    help="evaluation text file (default: deterministic "
                         "pseudo-text sized to fill the context)")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from qwen3_tpu_torch.config import fuse_from_env, native_tokenizer_from_env
    from qwen3_tpu_torch.eval.perplexity import sequence_nll
    from qwen3_tpu_torch.io.checkpoint import read_header
    from qwen3_tpu_torch.models.qwen3 import load_params
    from qwen3_tpu_torch.tokenizer import Tokenizer

    fuse = fuse_from_env()
    cfg = read_header(args.checkpoint).with_seq_len(args.ctx)
    tok = Tokenizer.from_file(args.checkpoint, native_tokenizer_from_env())
    text = (open(args.text, encoding="utf-8").read() if args.text
            else pseudo_text(8 * args.ctx))
    ids = tok.encode(text)[: args.ctx]
    if len(ids) < args.ctx // 2:
        print(f"[quality] warning: only {len(ids)} tokens for ctx "
              f"{args.ctx}", file=sys.stderr)

    runs = [(m, m, "float32") for m in args.modes.split(",")]
    if args.int8_kv:
        runs.append(("pallas+int8kv", "pallas", "int8"))

    ppl: dict[str, float] = {}
    for label, mode, kvd in runs:
        print(f"[quality] evaluating {label} (ctx={args.ctx}, "
              f"tokens={len(ids)})...", file=sys.stderr, flush=True)
        _, params = load_params(args.checkpoint, mode=mode,
                                max_seq_len=args.ctx, device=args.device)
        nll = sequence_nll(params, cfg, ids, mode=mode, kv_dtype=kvd,
                           chunk=args.chunk, fuse=fuse)
        ppl[label] = float(np.exp(nll.mean()))
        del params

    base = ppl.get("exact")
    rows = {}
    print("\n| path | ppl | delta vs exact | delta ln ppl |", file=sys.stderr)
    print("|---|---|---|---|", file=sys.stderr)
    ok = True
    for label, p in ppl.items():
        d = None if base is None else p - base
        dl = None if base is None else float(np.log(p) - np.log(base))
        rows[label] = {"ppl": round(p, 5),
                       "delta": None if d is None else round(d, 5),
                       "delta_ln": None if dl is None else round(dl, 6)}
        # the synthetic regime (exact's ppl > 100, far above any trained
        # Qwen3's) takes the log gate, |delta ln ppl| <= 0.005 == delta
        # ppl 0.05 at ppl 10; trained-model perplexities the absolute one
        if d is not None and (abs(dl) > 0.005 if base > 100.0
                              else abs(d) > 0.05):
            ok = False
        print(f"| {label} | {p:.5f} | "
              f"{'—' if d is None else f'{d:+.5f}'} | "
              f"{'—' if dl is None else f'{dl:+.6f}'} |", file=sys.stderr)
    print(json.dumps({"metric": "delta_ppl", "ctx": args.ctx,
                      "tokens": len(ids), "rows": rows, "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
