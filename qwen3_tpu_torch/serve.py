"""Batch-serving CLI of the CUDA port: the continuous-batching counterpart of
the runq-compatible single-stream CLI (qwen3_tpu_torch/cli.py), with
qwen3_tpu/serve.py's flags and defaults.

    python -m qwen3_tpu_torch.serve <checkpoint.bin> [options] < prompts.txt

Reads one prompt per line from stdin (or --prompts FILE), serves them all
through BatchedEngine (continuous batching over a fixed slot pool,
per-request seeds), and prints one JSON line per completed request to
stdout in completion order:

    {"id": 3, "prompt": "...", "text": "...", "n_tokens": 42,
     "prompt_ms": 12.3, "generate_ms": 345.6}

Diagnostics go to stderr with [Component] prefixes (reference convention).

  -t / -p / -s      sampler defaults (per-request seed = s + line index)
  -c                context window
  --max-tokens      per-request generation cap
  --batch           slot pool size (default 8)
  --qmode/--kv-dtype/--attn/--no-side-buffer   engine knobs (every qmode
                    of the CLI; QWEN3_TPU_FUSE=1 runs the matmuls of pallas
                    and pallas-fast through the prologue-fused kernel)
  --tp/--dp, --aot-dir   accepted for compatibility; not ported yet (> 1, or
                    a directory, raises)
  --device          torch device: cuda (default) or cpu (the kernels' plain
                    versions)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qwen3_tpu_torch.serve")
    ap.add_argument("checkpoint")
    ap.add_argument("-t", type=float, default=1.0)
    ap.add_argument("-p", type=float, default=0.9)
    ap.add_argument("-s", type=int, default=0)
    ap.add_argument("-c", type=int, default=1024)
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompts", default="-",
                    help="file with one prompt per line ('-' = stdin)")
    # defaults are the measured serving configuration (README/PROFILE.md):
    # every batched benchmark runs pallas-fast + int8 KV
    ap.add_argument("--qmode", default="pallas-fast",
                    choices=["exact", "bf16", "pallas", "pallas-fast",
                             "pallas-int8"])
    ap.add_argument("--kv-dtype", default="int8",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--attn", default="auto",
                    choices=["auto", "dense", "flash", "fused"])
    ap.add_argument("--no-side-buffer", dest="side_buffer",
                    action="store_false", default=True)
    ap.add_argument("--prefill-bucket", type=int, default=128)
    ap.add_argument("--decode-chunk", type=int, default=32)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--aot-dir", default=None,
                    help="the TPU's compiled-executable cache: not ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from qwen3_tpu_torch.config import fuse_from_env, native_tokenizer_from_env
    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request

    lines = (sys.stdin if args.prompts == "-"
             else open(args.prompts, encoding="utf-8"))
    prompts = [ln.rstrip("\n") for ln in lines if ln.strip()]
    if not prompts:
        print("[Serve] Error: no prompts.", file=sys.stderr)
        return 1

    seed0 = args.s if args.s else int(time.time())
    fuse = fuse_from_env()
    print(f"[Serve] loading {args.checkpoint} (mode={args.qmode}, "
          f"batch={args.batch}, tp={args.tp}, dp={args.dp}, "
          f"fuse={int(fuse)})", file=sys.stderr)
    t_load = time.perf_counter()
    eng = BatchedEngine(args.checkpoint, max_batch=args.batch,
                        seq_len=args.c, mode=args.qmode,
                        temperature=args.t, top_p=args.p,
                        kv_dtype=args.kv_dtype, attn=args.attn,
                        side_buffer=args.side_buffer,
                        prefill_bucket=args.prefill_bucket,
                        decode_chunk=args.decode_chunk,
                        tp=args.tp, dp=args.dp, aot_dir=args.aot_dir,
                        device=args.device, fuse=fuse,
                        native_tokenizer=native_tokenizer_from_env())
    print(f"[Serve] engine ready in {time.perf_counter() - t_load:.1f}s "
          f"(checkpoint load + device transfer; attn={eng.attn}, "
          f"device={eng.device})", file=sys.stderr)

    t0 = time.perf_counter()
    reqs = {}
    for i, prompt in enumerate(prompts):
        r = eng.submit(Request(prompt=prompt, seed=seed0 + i,
                               max_tokens=args.max_tokens))
        reqs[r.rid] = (i, prompt)
    done = eng.run()
    dt = time.perf_counter() - t0

    total = 0
    for r in done:
        i, prompt = reqs[r.rid]
        total += len(r.out_ids)
        print(json.dumps({
            "id": i, "prompt": prompt,
            "text": eng.tokenizer.decode(r.out_ids).decode(
                "utf-8", errors="replace"),
            "n_tokens": len(r.out_ids),
            "prompt_ms": round(r.prompt_ms, 1),
            "generate_ms": round(r.generate_ms, 1),
        }), flush=True)
    print(f"[Serve] {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s aggregate)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
