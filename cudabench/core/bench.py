"""One run of one cell: set-up, the measured window, the judgement of the
outputs, the result line.

Set-up (timed as `setup_s`, from the process's start): the port and its
kernels' library (built into the checkout's build/ at a checkout's first
run), the weights from the seed, the engine, the first wave prefilled and
one decode chunk. The window is the closed loop's (core/loop.py). With
`--trace 1` a sub-window of the cell's `trace` chunks is profiled
(core/trace.py). Then the program's state is freed, the reference judges
the served tokens (core/check.py), the process is checked for JAX and the
JAX package, and the last line of stdout is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType

from cudabench.core import check, spec, stats, tokfile
from cudabench.core.loop import ClosedLoop
from cudabench.core.traffic import RequestStream

# modules no run may hold once its window has closed, compared by the
# whole top-level name (the port's own name begins with the last one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tpu")


def forbidden_modules(modules=None) -> list[str]:
    mods = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in mods} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the cell, its model module
    (models/<model>.py) and the model's sizes, the closed loop's records
    and window, and the traced sub-window."""
    cell: spec.Cell
    model: ModuleType
    sizes: dict
    engine: dict
    setup_s: float
    loop: ClosedLoop
    phases: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    @property
    def records(self):
        return self.loop.records

    def window_records(self):
        """Requests submitted inside the window."""
        return [r for r in self.loop.records if self.loop.in_window(r)]

    def tokens(self, lo: int, hi: int) -> int:
        """Tokens delivered in the bursts after `lo` up to `hi`: the
        tokens generated by the decode steps (lo, hi]."""
        return sum(n for r in self.loop.records
                   for _, n, b in r.deliveries if lo < b <= hi)

    def positions(self, lo: int, hi: int) -> list[int]:
        """The cache position of every token generated by the decode steps
        (lo, hi]: the position its step fed it at."""
        out = []
        for r in self.loop.records:
            done = 0
            for _, n, b in r.deliveries:
                if lo < b <= hi:
                    out.extend(range(r.prompt_len + done,
                                     r.prompt_len + done + n))
                done += n
        return out

    def admitted(self, lo: int, hi: int) -> list[int]:
        """Prompt lengths of the requests admitted before the decode steps
        (lo, hi]: those whose first delivery falls there."""
        return [r.prompt_len for r in self.loop.records
                if r.deliveries and lo < r.deliveries[0][2] <= hi]


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="cudabench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def serve(cell: spec.Cell, seed: int, seconds: float, trace: bool,
          device, t_start: float, after_window=None):
    """Set up and serve one window. Returns (Run, memory peak bytes).
    `after_window(engine, run)` runs before the engine is freed."""
    import torch

    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request

    cfg, mix, eng_set = cell.config, cell.traffic, cell.config["engine"]
    model = model_of(cell)
    calls = model.counters()
    sizes = model.sizes_of(cfg)
    clock = time.perf_counter
    phases = {"imports": clock() - t_start}
    w = model.make(sizes, seed, cfg["weights"], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights"] = clock() - t_start
    mcfg, params = model.to_port(w, sizes, eng_set["seq_len"],
                                 eng_set["mode"], device)
    phases["init_params"] = clock() - t_start
    with tempfile.TemporaryDirectory(prefix="cudabench-") as tmp:
        tok = Path(tmp) / "bytes"
        tokfile.write(Path(f"{tok}.tokenizer"), sizes["vocab_size"])
        eng = BatchedEngine(
            str(tok), max_batch=eng_set["max_batch"],
            seq_len=eng_set["seq_len"], mode=eng_set["mode"],
            temperature=mix["temperature"], top_p=mix["top_p"],
            kv_dtype=eng_set["kv_dtype"],
            prefill_bucket=eng_set["prefill_bucket"],
            decode_chunk=eng_set["decode_chunk"], top_k=eng_set["top_k"],
            attn=eng_set["attn"], model_cfg=mcfg, params=params,
            device=device)
    del params
    phases["engine"] = clock() - t_start
    loop = ClosedLoop(eng, RequestStream(mix, seed), int(mix["clients"]),
                      steps=lambda: calls["decode_forward"],
                      request_type=Request)
    tracer = None
    if trace:
        from cudabench.core.trace import Tracer
        tracer = Tracer(loop, chunks=int(cell.settings["trace"]["chunks"]),
                        counters=lambda: calls,
                        cuda=device.type == "cuda")
    loop.run(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    phases["window"] = loop.t0 - t_start
    run = Run(cell=cell, model=model, sizes=sizes, engine=eng_set,
              setup_s=loop.t0 - t_start, loop=loop, phases=phases)
    if after_window is not None:
        after_window(eng, run)
    # the program's part is over: its state goes before the reference runs
    loop.eng = None
    del eng
    if tracer is not None:
        run.trace = tracer.finish()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, peak


def _module_of(cell: spec.Cell, key: str, folder: str) -> ModuleType:
    name = cell.config[key]
    return spec.load_module(cell.bench_dir / folder / f"{name}.py",
                            f"cudabench_{folder}_{name}")


def model_of(cell: spec.Cell) -> ModuleType:
    """The configuration's model module: its sizes, tensors, hand-over
    to the port and work counts (models/<model>.py)."""
    return _module_of(cell, "model", "models")


def reference_of(cell: spec.Cell) -> ModuleType:
    """The configuration's plain reference (reference/<reference>.py)."""
    return _module_of(cell, "reference", "reference")


def picked(cell: spec.Cell, run: Run, seed: int) -> list:
    """The samples of served requests the reference judges: the greedy
    ones, then the sampled ones."""
    budget = cell.settings["check"]
    return (check.sample(run.records, seed, int(budget["served_tokens"]),
                         greedy=True)
            + check.sample(run.records, seed, int(budget["sampled_tokens"]),
                           greedy=False))


def judge(cell: spec.Cell, run: Run, seed: int, device,
          extra_picks=None):
    """The reference's judgement of the run's served tokens (and of
    further token lists over the same sample, `extra_picks`)."""
    w = run.model.make(run.sizes, seed, cell.config["weights"], device)
    return check.judge(reference_of(cell), w, run.sizes,
                       picked(cell, run, seed), cell.settings["check"],
                       device, extra_picks)


def main(argv, *, t_start: float, root: Path, device: str = "cuda",
         require_card: bool = True) -> int:
    """One run; returns the exit code. `require_card=False` and
    `device="cpu"` are the CPU tests' way past the look for a card; a
    run from the command line always needs one."""
    args = parse(argv)
    os.environ["USE_FLAX"] = "0"
    try:
        cell = spec.load_cell(root, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"cudabench: {e}", file=sys.stderr)
        return 2
    import torch

    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cudabench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0" if device == "cuda" else device)
    run, peak = serve(cell, args.seed, args.seconds, bool(args.trace), dev,
                      t_start)
    metrics, others = {}, {}
    for m in cell.end_to_end + cell.per_layer:
        value = m.reader.read(run)
        if value is None:
            continue
        if (m in cell.per_layer) == bool(args.trace):
            metrics[m.name] = {"value": value, "unit": m.unit}
        else:
            others[m.name] = value
    checks, _ = judge(cell, run, args.seed, dev)

    found = forbidden_modules()
    if found:
        print(f"cudabench: the run loaded {found}: nothing it runs may "
              f"import JAX or the JAX package", file=sys.stderr)
        return 4
    window = run.window_records()
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device_info["power"] = _power_limit()
    result = {"correct": check.passed(checks),
              "attempted": len(window) + run.loop.clients,
              "failed": sum(1 for r in window
                            if not r.deliveries
                            and (r.req.finished or run.loop.stopped_early)),
              "metrics": metrics, "device": device_info}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    print("setup: " + ", ".join(f"{k} at {v:.3f} s"
                                for k, v in run.phases.items())
          + f"; torch threads {torch.get_num_threads()}", file=sys.stderr)
    loop = run.loop
    print(f"window: {loop.t_end - loop.t0:.3f} s, {len(window)} submitted "
          f"({stats.beyond(len(window), 0.95)} beyond their p95), "
          f"{loop.b_end - loop.b0} decode steps; chunks (steps, ms): "
          + " ".join(f"{b - a}:{(loop.bursts[b] - loop.bursts[a]) * 1e3:.0f}"
                     for a, b in zip(sorted(loop.bursts),
                                     sorted(loop.bursts)[1:])
                     if loop.b0 <= a < loop.b_end), file=sys.stderr)
    print(f"metrics not in the result: {json.dumps(others)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
