"""End to end from a multi-GB `.bin`: a synthetic checkpoint of a preset
(deepseek-r1-qwen3-8b by default, 8.1 GiB) through the port's own
generator, reader and serve.py on the card, with the wall time of every
stage, the serving metrics and the peak device memory. The port's
counterpart of the JAX package's tools/e2e_8b.py and tools/gen_8b_ckpt.py.

    python -m qwen3_tpu_torch.tools.e2e_8b [--preset deepseek-r1-qwen3-8b] \
        [--cache-dir .cache] [--out FILE] [--ctx 32768] [--max-tokens 96] \
        [--device cuda|cpu]

Stages:
  1. generate <cache-dir>/<preset>.bin and its .tokenizer with
     io/synthetic.py (seed 0, seq_len min(32768, the preset's)) unless the
     .bin exists, and beside it <preset>.bin.digest.json: the SHA-256 of
     the generator's arrays that lie past 4 GiB in an 8B file (the last
     layer's w2 and the classifier, values and scales). `gen_s` and
     `bin_gib`. The JAX tool's pack stage has no counterpart: the port
     loads the checkpoint's own layout, with no repack and no disk cache,
     so `pack_s` is absent.
  2. read back: the file's size against the header's arithmetic
     (checkpoint_bytes), then io/checkpoint.py::load_checkpoint and the
     digests of the same tensors against the generator's (`readback`).
  3. serve: qwen3_tpu_torch.serve.main in this process, --batch 1 --qmode
     pallas --kv-dtype int8 --attn flash -c <ctx> -t 0 -s 3 --max-tokens N,
     on the JAX tool's prompt; its metrics (parse_serve_output), the wall
     time and torch.cuda.max_memory_allocated (`serve`).

Prints one JSON line to stdout and, with --out, writes it there, merged
into the record the file already holds (a later run that finds the .bin
keeps the generating run's `gen_s`). Exits 1 when the size or a digest
differs or the serve fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import re
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PROMPT = ("the thinker thought the thought and the thought thought in the "
          "thinker and ") * 8
SEQ_LEN_CAP = 32768
# the generator's arrays checked after the load: (Q8Weights field, index of
# the layer, None for an unstacked tensor)
READBACK = (("w2_q", -1), ("w2_s", -1), ("cls_q", None), ("cls_s", None))


def checkpoint_bytes(cfg) -> int:
    """The .bin's size from its header's fields (io/checkpoint.py's
    layout): the 256-byte header, the fp32 norms, then every Q8_0 tensor's
    int8 values and fp32 scales (one a group), the classifier's when it is
    untied."""
    from qwen3_tpu_torch.config import HEADER_BYTES

    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    P, KV, G = cfg.proj_dim, cfg.kv_dim, cfg.group_size

    def q8(rows, cols):
        return rows * cols + 4 * (rows * cols // G)

    norms = 4 * (2 * L * D + D + 2 * L * cfg.head_dim)
    layers = L * (q8(P, D) + 2 * q8(KV, D) + q8(D, P) + 3 * q8(H, D))
    cls = 0 if cfg.shared_classifier else q8(V, D)
    return HEADER_BYTES + norms + q8(V, D) + layers + cls


def digests(w) -> dict:
    """SHA-256 of the READBACK arrays of Q8Weights `w`."""
    import numpy as np

    out = {}
    for name, layer in READBACK:
        a = getattr(w, name)
        a = np.ascontiguousarray(a if layer is None else a[layer])
        out[name if layer is None else f"{name}[{layer}]"] = hashlib.sha256(
            memoryview(a).cast("B")).hexdigest()
    return out


def generate(cfg, path: Path) -> dict:
    """Stage 1: the .bin, its .tokenizer and the digest sidecar; the
    generator's arrays are dropped before returning (one copy in RAM)."""
    from qwen3_tpu_torch.io.checkpoint import write_checkpoint
    from qwen3_tpu_torch.io.synthetic import (
        synthetic_tokenizer,
        synthetic_weights,
    )
    from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin

    t0 = time.perf_counter()
    w = synthetic_weights(cfg, seed=0)
    made_s = time.perf_counter() - t0
    sums = digests(w)
    write_checkpoint(str(path), w)
    del w
    write_tokenizer_bin(str(path) + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    Path(str(path) + ".digest.json").write_text(json.dumps(sums, indent=1))
    return {"gen_s": round(time.perf_counter() - t0, 1),
            "gen_arrays_s": round(made_s, 1)}


def readback(path: Path) -> dict:
    """Stage 2: the size against the header's arithmetic and the digests
    of the tensors past 4 GiB, read by the port's reader, against the
    generator's (None where no sidecar was written)."""
    from qwen3_tpu_torch.io.checkpoint import load_checkpoint, read_header

    t0 = time.perf_counter()
    cfg = read_header(str(path))
    size = path.stat().st_size
    out = {"bytes": size, "header_bytes": checkpoint_bytes(cfg)}
    out["size_ok"] = size == out["header_bytes"]
    sidecar = Path(str(path) + ".digest.json")
    want = json.loads(sidecar.read_text()) if sidecar.exists() else None
    w = load_checkpoint(str(path))
    got = digests(w)
    del w
    out["tensors"] = sorted(got)
    out["digests_ok"] = None if want is None else got == want
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def parse_serve_output(stdout: str, stderr: str) -> dict:
    """The serve stage's metrics from serve.py's stdout JSON lines and its
    stderr lines (`engine ready in ...s`, `N requests, T tokens in Ss (R
    tok/s aggregate)`), as the JAX tool parses its serve.py's."""
    serve: dict = {}
    m = re.search(r"engine ready in ([0-9.]+)s", stderr)
    if m:
        serve["engine_ready_s"] = float(m.group(1))
    m = re.search(r"(\d+) tokens in ([0-9.]+)s \(([0-9.]+) tok/s", stderr)
    if m:
        serve["n_tokens"] = int(m.group(1))
        serve["agg_tok_s"] = float(m.group(3))
    for line in stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if not isinstance(row, dict):
            continue
        serve["generate_ms"] = row.get("generate_ms")
        serve["prompt_ms"] = row.get("prompt_ms")
        if row.get("n_tokens") and row.get("generate_ms"):
            serve["steady_tok_s"] = round(
                row["n_tokens"] / (row["generate_ms"] / 1e3), 2)
    return serve


def serve_argv(path: Path, ctx: int, max_tokens: int, device: str,
               prompts: Path) -> list[str]:
    """serve.py's arguments for the serve stage (the JAX tool's, without
    --aot-dir, which the port refuses)."""
    return [str(path), "--batch", "1", "--qmode", "pallas", "--kv-dtype",
            "int8", "--attn", "flash", "-c", str(ctx), "-t", "0", "-s", "3",
            "--max-tokens", str(max_tokens), "--device", device,
            "--prompts", str(prompts)]


def serve_stage(path: Path, ctx: int, max_tokens: int, device: str) -> dict:
    """Stage 3: serve.main in this process on the JAX tool's prompt."""
    import torch

    from qwen3_tpu_torch import serve

    prompts = Path(str(path) + ".prompt.txt")
    prompts.write_text(PROMPT + "\n", encoding="utf-8")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = serve.main(serve_argv(path, ctx, max_tokens, device, prompts))
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = parse_serve_output(out.getvalue(), err.getvalue())
    res.update(rc=rc, wall_s=round(wall, 1), qmode="pallas", attn="flash",
               kv_dtype="int8", stdout=out.getvalue(),
               stderr_tail=err.getvalue()[-2000:],
               peak_device_gb=(round(torch.cuda.max_memory_allocated() / 1e9,
                                     3) if on_card else None))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qwen3_tpu_torch.tools.e2e_8b")
    ap.add_argument("--preset", default="deepseek-r1-qwen3-8b")
    ap.add_argument("--cache-dir", default=str(REPO / ".cache"))
    ap.add_argument("--out", default=None,
                    help="JSON record to write (merged into what it holds)")
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from qwen3_tpu_torch.config import PRESETS

    preset = PRESETS[args.preset]
    cfg = dataclasses.replace(preset,
                              seq_len=min(SEQ_LEN_CAP, preset.seq_len))
    cache = Path(args.cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    path = cache / f"{args.preset}.bin"
    result: dict = {}
    if args.out and Path(args.out).exists():
        try:
            result = json.loads(Path(args.out).read_text())
        except ValueError:
            result = {}
    result.update(preset=args.preset, ctx=args.ctx, bin=str(path))

    if not path.exists():
        print(f"[e2e-8b] stage 1: generating {path} ...", file=sys.stderr,
              flush=True)
        result.update(generate(cfg, path))
    else:
        result.setdefault("gen_s", None)     # present before: no timing
    result["bin_gib"] = round(path.stat().st_size / 2**30, 2)
    print("[e2e-8b] stage 2: reading back the tensors past 4 GiB ...",
          file=sys.stderr, flush=True)
    result["readback"] = readback(path)
    print("[e2e-8b] stage 3: serving ...", file=sys.stderr, flush=True)
    result["serve"] = serve_stage(path, args.ctx, args.max_tokens,
                                  args.device)

    rb = result["readback"]
    ok = (rb["size_ok"] and rb["digests_ok"] is not False
          and result["serve"]["rc"] == 0)
    result["ok"] = ok
    line = json.dumps(result)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
