"""Quality at depth: the port's quality table (tools/quality_table.py) at a
long context with the serving numerics (pallas, and pallas with the int8
KV cache), its rows written under a "<preset>@<ctx>" key into a JSON file.
The port's counterpart of the JAX package's tools/quality_depth.py: every
32k serving claim rides on int8-KV numerics, whose error grows with the
depth of the attention read, so the gate is measured at depth.

    python -m qwen3_tpu_torch.tools.quality_depth <model.bin> <ctx> \
        --out FILE [--preset NAME] [--modes exact,pallas] [--device cuda|cpu]

From ctx 16384 the table evaluates in chunks of 128 tokens (halving the
dense attention's [1, chunk, H, ctx] fp32 scores beside exact mode's fp32
cache). The key's preset is --preset, else the checkpoint's file name
without its suffix. Writes {"metric": "delta_ppl", "tables": {key: {"ctx",
"tokens", "rows", "pass"}}, "pass": all tables pass} to --out, merged into
what the file holds; prints {"merged": key, "pass", "overall"}. Exits 1
when a row misses the gate (as quality_table does), 2 when the table does
not run.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

DEEP_CHUNK_FROM = 16384
DEEP_CHUNK = 128


def table_argv(checkpoint: str, ctx: int, modes: str,
               device: str) -> list[str]:
    """quality_table's arguments at `ctx` (the int8-KV row on, its
    default)."""
    argv = [checkpoint, "-c", str(ctx), "--modes", modes, "--device", device]
    if ctx >= DEEP_CHUNK_FROM:
        argv += ["--chunk", str(DEEP_CHUNK)]
    return argv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tpu_torch.tools.quality_depth")
    ap.add_argument("checkpoint")
    ap.add_argument("ctx", type=int)
    ap.add_argument("--out", required=True,
                    help="JSON file the table is merged into")
    ap.add_argument("--preset", default=None,
                    help="the key's model name (default: the file's stem)")
    ap.add_argument("--modes", default="exact,pallas")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from qwen3_tpu_torch.tools import quality_table

    if not Path(args.checkpoint).exists():
        print(f"[quality_depth] missing {args.checkpoint}", file=sys.stderr)
        return 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = quality_table.main(table_argv(args.checkpoint, args.ctx,
                                           args.modes, args.device))
    lines = out.getvalue().strip().splitlines()
    if rc not in (0, 1) or not lines:
        print(f"[quality_depth] quality_table failed: rc {rc}",
              file=sys.stderr)
        return 2
    table = json.loads(lines[-1])

    preset = args.preset or Path(args.checkpoint).stem
    key = f"{preset}@{args.ctx}"
    qpath = Path(args.out)
    q = (json.loads(qpath.read_text()) if qpath.exists()
         else {"metric": "delta_ppl", "tables": {}})
    q.setdefault("tables", {})[key] = {
        "ctx": table["ctx"], "tokens": table["tokens"],
        "rows": table["rows"], "pass": table["pass"]}
    q["pass"] = all(t.get("pass") for t in q["tables"].values())
    qpath.write_text(json.dumps(q, indent=1) + "\n")
    print(json.dumps({"merged": key, "pass": table["pass"],
                      "overall": q["pass"]}))
    return 0 if table["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
