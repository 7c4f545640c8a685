"""The control of a cell's `correct`, its readings over seeds, and the
faults at the cell's own size.

    python3 cudabench/control.py --workload <name> --seeds a,b,c \
        --seconds <s> [--modes pallas-int8,reference-fp8] \
        [--faults state,half,token,temperature]

For each seed, in one process: a run's set-up and window as
cudabench/run.py makes them, then over the samples of served requests
that the run would judge, readings against the reference (the widest and
the mean gap of the greedy tokens, and of the sampled tokens' coins):

- `program`: of the tokens the program served (a sound run's readings,
  the lower ends of the limits);
- one per control mode: of the tokens that a lower precision picks at
  each position of the same prompts and served tokens, with the same
  coins. `pallas-int8` is the program's own such path: activations
  quantized to int8 per row and 512-wide k-tile, each weight tile
  requantized to one int8 scale a column, int8 products, the step below
  pallas-fast's bfloat16 products that would tempt a later change; its
  logits are picked from by the reference's sampler. `reference-fp8` is
  the reference with its activations rounded to float8 e4m3 (one scale a
  row) before every matmul. Each must read above a limit;
- with `--faults`, in place of these, one run per fault
  (cudabench/faults.py), each its own set-up and window with the fault
  planted under the timed path: `fault-<name>`, the program's readings
  and whether the run's check passed.

One JSON line a seed (and a fault) on stdout. The benchmark's runs never
run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_tokens(eng, model, picked, ref, dev,
                   mode: str = "pallas-int8") -> list:
    """At each position of each sampled sequence, the token that the
    program's forward in `mode` leads to (the model module's port_forward:
    the same parameters, an int8 KV cache of its own, prefill blocks of
    512 rows): its argmax for a greedy request, the reference's sampler
    over its logits with the request's coin for a sampled one."""
    import torch

    from cudabench.core import check

    seqs, first, served, draws = check.inputs(picked)
    out = []
    for seq, f, sv, d in zip(seqs, first, served, draws):
        rows = -(-len(seq) // 128) * 128
        k, v = model.port_cache(eng.cfg, rows, dev)
        coin = None if d is None else torch.tensor(ref.coins(d[2], len(sv)),
                                                   device=dev)
        got = []
        for off in range(0, len(seq), 512):
            blk = torch.tensor([seq[off:off + 512]], device=dev)
            logits, k, v = model.port_forward(eng.params, eng.cfg, blk, k, v,
                                              off, mode)
            lo, hi = max(f, off), min(f + len(sv), off + blk.shape[1])
            if lo < hi:
                got.extend(ref.pick_rows(
                    logits[0, lo - off:hi - off], d,
                    None if coin is None else coin[lo - f:hi - f]))
        out.append(got)
        del k, v
    return out


def reference_tokens(cell, run, seed: int, dev) -> list:
    """The reference's own picks with float8 activations."""
    from cudabench.core import bench, check

    seqs, first, served, draws = check.inputs(bench.picked(cell, run, seed))
    if not seqs:
        return []
    ref = bench.reference_of(cell)
    w = run.model.make(run.sizes, seed, cell.config["weights"], dev)
    return ref.picks(w, run.sizes, seqs, first, [len(s) for s in served],
                     draws, dev, act=ref.fp8_rows)


def readings(cell, seed: int, seconds: float, dev, modes=()) -> tuple:
    """One seed's set-up, window and judgement, with the control modes'
    picks beside the program's. Returns (checks, readings, seconds)."""
    from cudabench.core import bench

    got = {}
    ref = bench.reference_of(cell)

    def after(eng, run):
        for mode in modes:
            if mode.startswith("pallas"):
                got[mode] = control_tokens(
                    eng, run.model, bench.picked(cell, run, seed), ref, dev,
                    mode)

    t0 = time.perf_counter()
    run, _ = bench.serve(cell, seed, seconds, False, dev, t0,
                         after_window=after)
    if "reference-fp8" in modes:
        got["reference-fp8"] = reference_tokens(cell, run, seed, dev)
    checks, read = bench.judge(cell, run, seed, dev, extra_picks=got)
    return checks, read, time.perf_counter() - t0


def main(argv) -> int:
    import argparse

    import torch

    from cudabench import faults
    from cudabench.core import check, spec

    ap = argparse.ArgumentParser(prog="cudabench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="pallas-int8,reference-fp8")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    modes = [m for m in args.modes.split(",") if m]
    planted = [f for f in args.faults.split(",") if f]
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(ROOT, args.workload)
    dev = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in planted or [None]:
            if fault is None:
                checks, read, secs = readings(cell, seed, args.seconds, dev,
                                              modes)
            else:
                with faults.planted(fault):
                    checks, read, secs = readings(cell, seed, args.seconds,
                                                  dev)
                read = {f"fault-{fault}": read["program"]}
            print(json.dumps({
                "workload": cell.name, "seed": seed, **read,
                "passed": check.passed(checks),
                "tokens": checks["tokens"]["value"],
                "sampled_tokens": checks["sampled_tokens"]["value"],
                "seconds": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
