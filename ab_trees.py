#!/usr/bin/env python3
"""Two trees of this repository on one card, in turns P C C P: the same
output bytes, and their decode profiles side by side.

    python3 ab_trees.py --parent DIR [--out build/ab_trees.jsonl]

C, the change, is the tree this script lies in (beside the chip_smoke.py
whose functions it drives); P, the parent, is another checkout of the
repository (an unpacked `git archive` of the parent commit, say). A turn
runs one tree's own code in fresh processes from that tree's root: its
chip_smoke.py builds that tree's kernels into its own build/ directory. Both
trees read one checkpoint, qwen3-0.6b at full size with random weights from
seed 0 (the change tree's chip_smoke.write_checkpoint, the one chip_smoke.py
drives), in a work directory that is deleted at the end.

The first two turns run the outputs that a change which keeps every bit
must leave alone: the CLI (mode pallas, int8 KV) greedy and seeded, also
with --attn flash, QWEN3_TPU_FUSE=1 and --tp 2; serve.py (its defaults, B
= 8, 16 prompts) greedy and seeded, also with --dp 2. Their stdout (the
records without their timing fields) must be byte-equal between the trees.
Every turn then runs the profiles of chip_smoke.py phase 6 (the CLI in
pallas, with fuse and in pallas-int8; the fused chunk; serving at B = 8 and
64) in that tree's own chip_smoke.py, whose `profile` lines are kept.

Prints one JSON line a turn and, last, a summary: which outputs differ
(none may), and per profile each turn's PyTorch kernels, device-busy ms and
wall ms a step. Exits 1 on a differing output or a failed run. Needs a
card; the trees must hold the same profile functions (phase_profile,
phase_chunk_profile, phase_serving_profile).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke

REPO = Path(__file__).resolve().parent
TURNS = "PCCP"               # the trees in turn; turns 0-1 run the outputs
PROMPT_WORDS = 80            # the CLI prompt: the first words of PROMPT
CLI_TOKENS = 32
SERVE_PROMPTS, SERVE_TOKENS = 16, 16
PROFILES = (
    "c.phase_profile(torch, p)",
    "c.phase_profile(torch, p, fuse=True)",
    "c.phase_profile(torch, p, mode='pallas-int8')",
    "c.phase_chunk_profile(torch, p, w)",
    "c.phase_serving_profile(torch, p, 8, 1024)",
    "c.phase_serving_profile(torch, p, 64, 512)",
)
PROFILE_LINE = re.compile(r"\[chip_smoke\] (?:chunk |serving )?profile (\{.*\})")


def run(tree: Path, argv: list[str], env=None,
        timeout: int = 900) -> subprocess.CompletedProcess:
    """argv in a fresh process from `tree`'s root, its package first on
    the path."""
    full = dict(os.environ, PYTHONPATH=str(tree), **(env or {}))
    return subprocess.run([sys.executable, *argv], cwd=tree, env=full,
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=timeout)


def outputs(tree: Path, ckpt: str, prompt: str, prompts: Path) -> dict:
    """{run: {sha256 and length of its stdout (serve.py's records without
    their timing fields), wall seconds, the tok/s it printed}}."""
    cli = ["-m", "qwen3_tpu_torch.cli", ckpt, "-m", "completion", "-i",
           prompt, "-c", "4096", "--max-tokens", str(CLI_TOKENS)]
    serve = ["-m", "qwen3_tpu_torch.serve", ckpt, "-c", "1024",
             "--max-tokens", str(SERVE_TOKENS), "--batch", "8", "--prompts",
             str(prompts)]
    greedy, seeded = ["-t", "0", "-s", "3"], ["-t", "0.8", "-p", "0.9", "-s",
                                              "7"]
    runs = {}
    for name, argv, env in (
            ("cli", cli, None), ("cli flash", cli + ["--attn", "flash"], None),
            ("cli fuse", cli, {"QWEN3_TPU_FUSE": "1"}),
            ("cli tp2", cli + ["--tp", "2"], None),
            ("serve", serve, None), ("serve dp2", serve + ["--dp", "2"],
                                     None)):
        for kind, flags in (("greedy", greedy), ("seeded", seeded)):
            t0 = time.perf_counter()
            proc = run(tree, argv + flags, env)
            if proc.returncode != 0:
                raise RuntimeError(f"{tree}: {name} {kind} returned "
                                   f"{proc.returncode}:\n{proc.stderr}")
            out = proc.stdout
            if name.startswith("serve"):
                recs = [json.loads(ln) for ln in out.splitlines()]
                out = json.dumps([{k: r[k] for k in ("id", "prompt", "text",
                                                     "n_tokens")}
                                  for r in recs])
            tok_s = re.findall(r"\[tok/s ([0-9.]+)\]|([0-9.]+) tok/s",
                               proc.stderr)
            runs[f"{name} {kind}"] = dict(
                sha256=hashlib.sha256(out.encode()).hexdigest(),
                bytes=len(out), wall_s=time.perf_counter() - t0,
                tok_s=[a or b for a, b in tok_s][-1:])
    return runs


def profiles(tree: Path, ckpt: str, work: Path) -> list[dict]:
    """The tree's own chip_smoke.py phase-6 profiles, one process."""
    code = ("import sys, torch; from pathlib import Path; "
            "import chip_smoke as c; p, w = sys.argv[1], Path(sys.argv[2]); "
            "c.phase_device(torch); c.phase_build(); "
            + "; ".join(PROFILES))
    proc = run(tree, ["-c", code, ckpt, str(work)], timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: profiles returned {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(m) for m in PROFILE_LINE.findall(proc.stdout)]


def profile_key(p: dict) -> str:
    if "label" in p:
        return p["label"]
    if "mode" in p:
        return f"cli {p['mode']}" + (" fuse" if p["fuse"] else "")
    return f"serving B={p['batch']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the parent commit")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write each turn's line and the summary here "
                         "(JSON lines, each as it comes)")
    args = ap.parse_args(argv)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out is not None:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")
    trees = {"P": args.parent.resolve(), "C": REPO}
    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ab_trees_", dir=REPO / "build"))
    try:
        ckpt = chip_smoke.write_checkpoint(work)
        prompt = " ".join(chip_smoke.PROMPT.split()[:PROMPT_WORDS])
        prompts = work / "prompts.txt"
        prompts.write_text("\n".join(chip_smoke.serve_prompts(
            SERVE_PROMPTS, 3, 40, seed=5)) + "\n", encoding="utf-8")
        turns = []
        for i, who in enumerate(TURNS):
            t0 = time.perf_counter()
            turn = {"turn": i, "tree": who}
            if i < 2:
                turn["outputs"] = outputs(trees[who], ckpt, prompt, prompts)
            turn["profiles"] = profiles(trees[who], ckpt, work)
            turn["seconds"] = time.perf_counter() - t0
            turns.append(turn)
            emit(turn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    firsts = {t["tree"]: t["outputs"] for t in turns if "outputs" in t}
    differ = sorted(k for k in firsts["P"]
                    if firsts["P"][k]["sha256"] != firsts["C"][k]["sha256"])
    table = {}
    for t in turns:
        for p in t["profiles"]:
            if "forward_passes" in p:          # the CLI: per forward pass
                n = p["forward_passes"]
                kernels, busy = p["kernels"] / n, p["device_busy_ms"] / n
                wall = p["wall_ms"] / n
            else:                              # the chunk and serving
                kernels = p["kernels_per_step"]
                busy = p["device_busy_ms_per_step"]
                wall = (p["wall_ms_per_step"] if "wall_ms_per_step" in p
                        else p["wall_ms"] / p["steps"])
            table.setdefault(profile_key(p), []).append(dict(
                tree=t["tree"], kernels=kernels, busy_ms=busy,
                wall_ms=wall, idle=p["device_idle_share"]))
    emit({"outputs_differ": differ, "profiles": table})
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
