#!/usr/bin/env python3
"""Smoke test and kernel measurement of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It drives the port (qwen3_tpu_torch) only and imports nothing of JAX or of
the JAX package. Phases, in order; any failure exits non-zero before the
final line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off;
2. build: nvcc builds the kernels from qwen3_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card at
   Qwen3-0.6B's main-path shapes (b = 1, 64, 256, 512), bit for bit, with device
   times (CUDA events, median of 20 runs after warm-up), the bound and a
   library yardstick; then the sampler on the card against its CPU run at
   the vocabulary of qwen3-0.6b (see check_sampler);
4. end to end: a synthetic qwen3-0.6b checkpoint (full width and depth,
   random weights from a seed) through the port's CLI main() with its
   defaults (--qmode pallas --kv-dtype int8 --attn auto --device cuda):
   greedy completion, a seeded completion twice (equal stdout), two chat
   turns; after each run the kernels' launch counts must equal what its
   forward passes need;
5. the path against its plain version: one 64-token prefill block on the
   card and on the CPU (plain versions), step by step with the card's
   rounding decisions forced on the CPU (every op within 1e-5 of its max,
   every rounding step bit for bit, logits and argmax), and free-running
   within twice the CPU path's own spread under a one-ulp nudge of its
   input (see phase_plain_path);
6. profile: torch.profiler over a warm greedy completion (one prefill
   block, 64 decode steps): device time by kernel and the device's idle
   share.

The last two lines are a JSON object of per-kernel numbers and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Qwen3-0.6B (HF config.json): dim 1024, hidden 3072, 28 layers, 16/8 heads
# of 128, vocab 151936, Q8_0 groups of 64
L, G = 28, 64
MATRICES = {           # name: (n = in, d = out)
    "wqkv": (1024, 4096),
    "wo": (2048, 1024),
    "w13": (1024, 6144),
    "w2": (3072, 1024),
    "classifier": (1024, 151936),
}
BATCHES = (1, 64, 256, 512)    # decode, and the prefill ladder's blocks
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
REPS, WARMUP = 20, 3
SLEEP_CYCLES = 4_000_000       # a ~2 ms device spin queued before each timed run


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# -- phase 1 -------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch.cuda: {name} | torch {torch.__version__} "
        f"| CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card, name


# -- phase 2 -------------------------------------------------------------------

def phase_build():
    from qwen3_tpu_torch.ops.cuda import build

    secs = build.build(verbose=True)
    for line in build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"ptxas: {line.strip()}")
    build.load_library()
    log(f"build: {secs:.2f} s")


# -- phase 3 -------------------------------------------------------------------

def device_ms(torch, fn, reps=REPS):
    """Median device time of fn(i) over `reps` runs: each run sits between
    two CUDA events behind a device spin, so the host's launch time does not
    show."""
    for i in range(WARMUP):
        fn(i)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (a, b) in enumerate(ev):
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(b, n, d):
    """The least time for the function: bytes it must move (weights, their
    scales, the activations and their scales read once, the output written
    once) over the memory rate, or its int8 operations over the peak."""
    nbytes = d * n + 4 * d * (n // G) + b * n + 4 * b * (n // G) + 4 * b * d
    ops = 2 * b * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.q8 import quantize_act

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for name, (n, d) in MATRICES.items():
        stacked = name != "classifier"
        lead = (L,) if stacked else ()
        w_q = torch.randint(-127, 128, lead + (d, n), dtype=torch.int8,
                            device=dev, generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(lead + (d, n // G), device=dev,
                                             generator=gen))
        # the library yardstick's weights, dequantized once to bf16
        w_bf = (w_q.float().reshape(*lead, d, n // G, G)
                * w_s[..., None]).reshape(*lead, d, n).to(torch.bfloat16)
        n_layers = L if stacked else 1
        for b in BATCHES:
            x = torch.randn(b, n, device=dev, generator=gen)
            xq, xs = quantize_act(x, G)
            x_bf = x.to(torch.bfloat16)

            def kernel(i, xq=xq, xs=xs):
                if stacked:
                    return qm.q8_q8_matmul_stacked(xq, xs, w_q, w_s,
                                                   i % L, G)
                return qm.q8_q8_matmul_tiled(xq, xs, w_q, w_s, G)

            def plain(i, xq=xq, xs=xs):
                if stacked:
                    return qm.q8q8_matmul_plain(xq, xs, w_q[i % L],
                                                w_s[i % L], G)
                return qm.q8q8_matmul_plain(xq, xs, w_q, w_s, G)

            def library(i, x_bf=x_bf):
                return F.linear(x_bf, w_bf[i % L] if stacked else w_bf)

            layers = (0, L - 1) if name == "wqkv" else (L - 1,)
            err = 0.0
            for layer in (layers if stacked else (0,)):
                got = kernel(layer)
                want = plain(layer)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"{name} b={b}: non-finite kernel output")
                err = max(err, (got - want).abs().max().item())
                if not torch.equal(got, want):
                    fail(f"{name} b={b} layer={layer}: kernel != plain "
                         f"(max_abs_diff {err:.3e})")
            k_ms = device_ms(torch, kernel)
            p_ms = device_ms(torch, plain)
            l_ms = device_ms(torch, library)
            bnd, by = bound_ms(b, n, d)
            row = dict(matrix=name, kernel="stacked" if stacked else "tiled",
                       b=b, n=n, d=d, layers_cycled=n_layers,
                       max_abs_diff=err, kernel_ms=k_ms, bound_ms=bnd,
                       bound_by=by, plain_ms=p_ms, library_ms=l_ms)
            rows.append(row)
            log("kernel " + json.dumps(row))
        del w_q, w_s, w_bf
        torch.cuda.empty_cache()
    log("library_ms = torch.nn.functional.linear on bf16 activations and "
        "the weights dequantized once to bf16 (no single PyTorch call "
        "computes the grouped int8 function); timed here, never called by "
        "the port")
    return rows


def check_sampler(torch, n_rows=64, vocab=151936, seed=0):
    """The sampler on the card against its run on the CPU (which
    tests/test_torch_runtime.py holds to the JAX package) on the same
    logits and coins, at qwen3-0.6b's vocabulary, t 0.8, top_k_hint as the
    engine passes it. Four cases, each checked to run the path it names:
    peaked logits whose top 64 hold more than top_p (the top-k fast path);
    spread logits at top_p 0.9 (the full-vocabulary scan); flat logits at
    the clamped top_p 1e-6, whose nucleus mass lies below 1e-3 (the heal
    branch, and the fallback index for coins past the healed mass), through
    the fast path and through the full scan. The picks must be equal, save
    that the two devices' prefix sums over the whole vocabulary differ by
    float32 rounding: in the full scan a tenth of the rows at most may pick
    another token, and only one whose float64 cumulative interval lies
    within 2e-5 of the coin's point. The card must repeat its own picks.
    Returns {case: rows that differ}."""
    import numpy as np

    from qwen3_tpu_torch.runtime.sampler import sample_tokens

    rng = np.random.default_rng(seed)
    temp, k = 0.8, 64
    coins = torch.from_numpy(rng.random(n_rows, dtype=np.float32))
    z = rng.standard_normal((n_rows, vocab), dtype=np.float32)
    peaked = z.copy()
    for row in peaked:
        row[rng.choice(vocab, 16, replace=False)] += (
            15 + 2 * rng.random(16, dtype=np.float32))
    cases = (    # name, logits, top_p, top_k_hint, (fast path, healed)
        ("top-64 fast path", peaked, 0.9, k, (True, False)),
        ("full scan", 2 * z, 0.9, k, (False, False)),
        ("healed mass, top-64", 0.5 * z, 1e-6, k, (True, True)),
        ("healed mass, full scan", 0.5 * z, 1e-6, 0, (False, True)))
    report = {}
    for name, logits, top_p, hint, path in cases:
        x = torch.from_numpy(logits)
        want = sample_tokens(x, coins, temp, top_p, top_k_hint=hint)
        got = [sample_tokens(x.cuda(), coins.cuda(), temp, top_p,
                             top_k_hint=hint).cpu() for _ in range(2)]
        if not torch.equal(got[0], got[1]):
            fail(f"sampler, {name}: the card's picks differ between runs")
        got = got[0]
        probs = torch.softmax(x.double() / temp, dim=-1)
        sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        fast = bool(hint) and bool(
            (sp[:, :k].sum(-1) > max(top_p, 1e-3)).all())
        healed = bool(((sp[:, 0] > top_p) & (sp[:, 0] < 1e-3)).all())
        if (fast, healed) != path:
            fail(f"sampler, {name}: the inputs do not take that path")
        rows = torch.nonzero(got != want)[:, 0]
        if len(rows) and (fast or healed or len(rows) > n_rows // 10):
            fail(f"sampler, {name}: card {got[rows].tolist()} vs CPU "
                 f"{want[rows].tolist()} in rows {rows.tolist()}")
        cum = sp.cumsum(-1)
        for i in rows.tolist():
            idx = int(torch.nonzero(cum[i] > top_p)[0, 0])
            r = coins[i].item() * cum[i, idx].item()
            rank = int(torch.nonzero(order[i] == got[i])[0, 0])
            lo = cum[i, rank - 1].item() if rank else 0.0
            if max(lo - r, r - cum[i, rank].item()) > 2e-5:
                fail(f"sampler, {name}, row {i}: the card's token lies "
                     f"outside 2e-5 of the coin's point")
        report[name] = len(rows)
    log(f"sampler on the card vs CPU (rows of {n_rows} that differ): "
        f"{report}")
    return report


# -- phase 4 -------------------------------------------------------------------

PROMPT = (
    "Once upon a time there was a small town at the edge of a forest, and "
    "in the town there lived an old clockmaker and the children who came to "
    "watch him work. "
) * 7


def write_checkpoint(workdir: Path) -> str:
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.checkpoint import write_checkpoint as wc
    from qwen3_tpu_torch.io.synthetic import (
        synthetic_tokenizer,
        synthetic_weights,
    )
    from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin

    cfg = PRESETS["qwen3-0.6b"]
    path = str(workdir / "qwen3-0.6b-synthetic.bin")
    t0 = time.perf_counter()
    wc(path, synthetic_weights(cfg, seed=0))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    size = Path(path).stat().st_size
    log(f"checkpoint: {path} ({size / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return path


def run_cli(argv, stdin_text=""):
    """The port's CLI main() in this process; returns (stdout bytes,
    stderr text)."""
    from qwen3_tpu_torch import cli

    out = io.BytesIO()
    err = io.StringIO()
    old_out, old_in = sys.stdout, sys.stdin
    sys.stdout = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        sys.stdout.flush()
        sys.stdout.detach()         # keep `out` open past the wrapper
        sys.stdout, sys.stdin = old_out, old_in
    if rc != 0:
        fail(f"cli {argv} returned {rc}:\n{err.getvalue()}")
    return out.getvalue(), err.getvalue()


def checked_run(torch, label, argv, stdin_text=""):
    """One CLI run with the launch-count check: every forward pass (prefill
    block or decode step) launches the stacked kernel 4 x 28 times and the
    classifier kernel once."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm

    before = dict(qm.LAUNCHES), dict(model.CALLS)
    t0 = time.perf_counter()
    out, err = run_cli(argv, stdin_text)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: qm.LAUNCHES[k] - before[0][k] for k in qm.LAUNCHES}
    blocks = model.CALLS["forward"] - before[1]["forward"]
    steps = model.CALLS["decode_forward"] - before[1]["decode_forward"]
    passes = blocks + steps
    if steps == 0 or blocks == 0:
        fail(f"{label}: no prefill block or no decode step ran")
    if launches != {"stacked": 4 * L * passes, "tiled": passes}:
        fail(f"{label}: launches {launches} for {blocks} prefill blocks and "
             f"{steps} decode steps (want stacked {4 * L * passes}, "
             f"tiled {passes})")
    metrics = re.findall(r"\[(pp|tg|t/ms|tok/s) ([0-9.]+)(?:ms)?\]", err)
    log(f"{label}: {len(out)} stdout bytes, {blocks} prefill blocks, "
        f"{steps} decode steps, launches {launches}, wall {wall:.2f} s, "
        f"cli {metrics}")
    return out, err, dict(blocks=blocks, steps=steps, launches=launches,
                          metrics=metrics)


def phase_end_to_end(torch, path: str):
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.runtime.decode_loop import prefill_plan
    from qwen3_tpu_torch.tokenizer import Tokenizer

    base = [path, "--device", "cuda"]     # CLI defaults otherwise
    n_prompt = len(Tokenizer.from_file(path).encode(PROMPT))
    plan = prefill_plan(n_prompt, 0, 64, 4096)
    log(f"prompt: {len(PROMPT.encode())} bytes, {n_prompt} tokens, prefill "
        f"plan {[w for _, w in plan]}")
    if max(w for _, w in plan) != 512:
        fail("the prompt does not reach a 512-row prefill block")

    qm.reset_launches()
    runs = {}
    out, err, runs["greedy"] = checked_run(
        torch, "greedy", base + ["-m", "completion", "-i", PROMPT, "-t", "0",
                                 "-s", "42", "-c", "4096",
                                 "--max-tokens", "128"])
    if runs["greedy"]["blocks"] != len(plan):
        fail(f"greedy: {runs['greedy']['blocks']} prefill blocks, plan has "
             f"{len(plan)}")
    if not out.startswith(PROMPT.encode()):
        fail("greedy: stdout does not start with the prompt")
    seeded = base + ["-m", "completion", "-i", PROMPT, "-t", "0.8", "-p",
                     "0.9", "-s", "7", "-c", "4096", "--max-tokens", "128"]
    out1, _, runs["seeded_1"] = checked_run(torch, "seeded run 1", seeded)
    out2, _, runs["seeded_2"] = checked_run(torch, "seeded run 2", seeded)
    if out1 != out2:
        fail("seeded: the two runs printed different bytes")
    out, err, runs["chat"] = checked_run(
        torch, "chat", base + ["-m", "chat", "-t", "0.8", "-s", "11", "-c",
                               "384", "-y", "You are brief."],
        stdin_text="Tell me about the clockmaker.\nAnd the children?\n\n")
    if err.count("[t/ms") != 2:
        fail("chat: expected two turns with metrics")
    total = dict(qm.LAUNCHES)
    log(f"main path launches (all phase-4 runs): {total}")
    return total, runs


# -- phase 5 -------------------------------------------------------------------

def phase_plain_path(torch, path: str):
    """One 64-token prefill block at full size on the card and on the CPU
    (plain versions), two ways.

    Step by step: the ops between two rounding steps are compared, free of
    the rounding itself. A rounding step is a Q8 activation quantization
    (before each matmul) or an int8 KV encode. The card records each step's
    input and output; the CPU then runs the same block and takes the card's
    output at every step, so both run the kernels on the same integers and
    the residual stream stays the same. Each step's input on the CPU must
    agree with the card's within 1e-5 of its max|.| (the ops between the
    steps, rmsnorm, rope, attention and swiglu, differ by ulps); each step
    on the CPU must give the card's output bit for bit from the card's
    input; the logits must agree within 1e-3 * max|logits| at all 64
    positions, with the same argmax at the position whose CPU top-2 gap is
    widest (which must exceed the tolerance, or the check would be empty).

    Free-running: the whole forward on each device, last-position logits.
    Without the forcing, an ulp can put an activation on the other side of
    a rounding boundary and move it a whole quantization step, and over 28
    layers of random weights such flips compound. So this comparison is
    held to the function's own sensitivity, measured here: the CPU path
    against itself with every input embedding scale nudged one ulp up, and
    one ulp down. The card must stay within twice that spread (and may
    always differ by 1e-3 * max|logits|)."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime import kvcache as kvc
    from qwen3_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer.from_file(path).encode(PROMPT)[:64]
    steps = {"q8": (model, "quantize_act"), "kv": (kvc, "quantize_heads")}
    rounding = {k: getattr(*where) for k, where in steps.items()}
    card_log = {k: [] for k in steps}       # (input, outputs), on the host
    cpu_in = {k: [] for k in steps}

    def record(kind):
        def step(x, *rest):
            out = rounding[kind](x, *rest)
            card_log[kind].append((x.cpu(), [t.cpu() for t in out]))
            return out
        return step

    def forced(kind):
        def step(x, *rest):
            cpu_in[kind].append(x)
            return card_log[kind][len(cpu_in[kind]) - 1][1]
        return step

    def logits_of(params, cfg, device, nudge=0.0, spy=None):
        if nudge:   # emb_s only: a tied classifier keeps its own reference
            params = dict(params, emb_s=torch.nextafter(
                params["emb_s"], torch.full_like(params["emb_s"], nudge)))
        k, v = model.init_kv_cache(cfg, 1, 256, "int8", device)
        toks = torch.tensor([ids], device=device)
        for kind, (mod, name) in steps.items():
            setattr(mod, name, spy(kind) if spy else rounding[kind])
        try:
            logits, _, _ = model.forward(params, cfg, toks, k, v, 0,
                                         all_logits=True)
        finally:
            for kind, (mod, name) in steps.items():
                setattr(mod, name, rounding[kind])
        return logits[0].float().cpu()                      # [64, V]

    cfg, params = model.load_params(path, max_seq_len=256, device="cuda")
    card = logits_of(params, cfg, "cuda", spy=record)
    card_nudged = logits_of(params, cfg, "cuda", float("inf"))[-1]
    del params
    cfg, params = model.load_params(path, max_seq_len=256, device="cpu")
    forced_cpu = logits_of(params, cfg, "cpu", spy=forced)
    free = {s: logits_of(params, cfg, "cpu", s)[-1]
            for s in (0.0, float("inf"), float("-inf"))}
    del params
    if card.shape != (64, cfg.vocab_size) or not torch.isfinite(card).all():
        fail(f"prefill logits: shape {tuple(card.shape)} or non-finite")

    # step by step
    want_steps = {"q8": 4 * cfg.n_layers + 1, "kv": 2 * cfg.n_layers}
    rel, unequal = {}, {}
    for kind in steps:
        rel[kind] = [((c - x).abs().max() / x.abs().max()).item()
                     for (x, _), c in zip(card_log[kind], cpu_in[kind])]
        g = (cfg.group_size,) if kind == "q8" else ()
        unequal[kind] = [
            i for i, (x, outs) in enumerate(card_log[kind])
            if not all(map(torch.equal, rounding[kind](x, *g), outs))]
    tol = 1e-3 * forced_cpu.abs().max().item()
    diff = (card - forced_cpu).abs().max().item()
    top2 = torch.topk(forced_cpu, 2, dim=-1).values
    gaps = top2[:, 0] - top2[:, 1]
    t = int(gaps.argmax())
    argmax = int(card[t].argmax()), int(forced_cpu[t].argmax())
    for kind in steps:
        worst = max(rel[kind])
        log(f"prefill block (64 tokens) step by step, {kind} rounding: "
            f"{len(rel[kind])} steps, CPU input vs the card's max|diff|/"
            f"max|x| worst {worst:.3e} (step {rel[kind].index(worst)}), "
            f"median {statistics.median(rel[kind]):.3e}; steps whose "
            f"output on the CPU from the card's input differs: "
            f"{unequal[kind]}")
    log(f"prefill block step by step: logits max_abs_diff {diff:.3e}, "
        f"tolerance {tol:.3e}; argmax at position {t} (CPU top-2 gap "
        f"{gaps[t].item():.3e}) {argmax[0]} / {argmax[1]}")
    if {k: len(v) for k, v in rel.items()} != want_steps:
        fail(f"rounding steps {({k: len(v) for k, v in rel.items()})}, "
             f"want {want_steps}")
    if max(max(r) for r in rel.values()) > 1e-5:
        fail("an op between two rounding steps disagrees on the card")
    if any(unequal.values()):
        fail("a rounding step on the card differs from the CPU's")
    if diff > tol:
        fail("logits on the card disagree with the CPU plain path")
    if gaps[t].item() <= tol:
        fail("no position's CPU top-2 gap exceeds the tolerance")
    if argmax[0] != argmax[1]:
        fail("argmax on the card differs from the CPU plain path")

    # free-running
    cpu = free[0.0]
    diff_free = (card[-1] - cpu).abs().max().item()
    spread = max((free[s] - cpu).abs().max().item()
                 for s in (float("inf"), float("-inf")))
    scale = cpu.abs().max().item()
    tol_free = max(2 * spread, 1e-3 * scale)
    log(f"prefill block (64 tokens) free-running, card vs CPU plain: "
        f"last-position max_abs_diff {diff_free:.3e}; CPU one-ulp input "
        f"spread {spread:.3e} (card one-ulp spread "
        f"{(card_nudged - card[-1]).abs().max().item():.3e}); max|logits| "
        f"{scale:.3e}; tolerance {tol_free:.3e}; argmax "
        f"{int(card[-1].argmax())} / {int(cpu.argmax())}")
    if diff_free > tol_free:
        fail("free-running logits on the card disagree with the CPU plain "
             "path")
    return diff, diff_free


# -- phase 6 -------------------------------------------------------------------

def kernel_name(name: str) -> str:
    """A short name for a kernel in the trace: its own name without
    namespaces and template arguments, plus the innermost functor or op a
    PyTorch or CUTLASS kernel is templated on ("..._kernel[MulFunctor]")."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base.removeprefix("void "), maxsplit=1)[0]
    short = base.split("::")[-1].strip()
    inner = re.findall(r"\w+Functor|\w+Ops\b|cutlass_\w+", name)
    return f"{short}[{inner[-1]}]" if inner else short


def phase_profile(torch, path: str):
    """Where a decode step's time goes, over a warm greedy completion (one
    64-row prefill block, then 64 decode steps): first timed alone, then
    again under torch.profiler, read from its Chrome trace. Reports device
    time by kernel, kernels per forward pass, and the device's idle share:
    1 - busy / wall, with the busy time from the trace and the wall time
    from the run without the profiler (whose own overhead would inflate
    it); the share within the profiled span is printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig

    eng = Engine(EngineConfig(path=path, temperature=0.0, seed=1,
                              kv_dtype="int8", seq_len=4096, device="cuda"))
    prompt = PROMPT[:60]
    eng.generate(prompt, max_tokens=8)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = eng.generate(prompt, max_tokens=64)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    calls = sum(model.CALLS.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompt, max_tokens=64)
        torch.cuda.synchronize()
    passes = sum(model.CALLS.values()) - calls
    trace = Path(path).with_suffix(".trace.json")
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sorted((float(e["ts"]), float(e["dur"]), e["name"])
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        log("profile: the trace holds no kernel events; device time not "
            "measured")
        return None
    busy, end = 0.0, kernels[0][0]
    by_name: dict[str, float] = {}
    for ts, dur, name in kernels:
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
        short = kernel_name(name)
        by_name[short] = by_name.get(short, 0.0) + dur
    span = end - kernels[0][0]
    q8 = sum(v for k, v in by_name.items() if k.startswith("q8q8"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(wall_ms=wall_ms, n_generated=plain.n_generated,
               prompt_ms=plain.prompt_ms, generate_ms=plain.generate_ms,
               ms_per_token=plain.ms_per_token, forward_passes=passes,
               kernels=len(kernels), kernels_per_pass=len(kernels) / passes,
               device_busy_ms=busy / 1e3, q8q8_kernel_ms=q8 / 1e3,
               device_idle_share=1.0 - busy / 1e3 / wall_ms,
               profiled_span_ms=span / 1e3,
               profiled_idle_share=1.0 - busy / span,
               top_kernels_ms={k: v / 1e3 for k, v in top})
    log("profile " + json.dumps(out))
    return out


# -- report --------------------------------------------------------------------

def kernel_report(rows, launches):
    """Per kernel, the main path's decode shapes (b = 1) summed over one
    decoded token: 4 stacked matmuls x 28 layers, 1 classifier matmul."""
    out = []
    for kind, source_line in (("stacked", 419), ("tiled", 314)):
        mine = [r for r in rows if r["kernel"] == kind]
        dec = [r for r in mine if r["b"] == 1]
        per_token = L if kind == "stacked" else 1
        total_bytes_ms = sum(r["bound_ms"] for r in dec) * per_token
        out.append({
            "name": f"q8_q8_matmul_{kind}",
            "route": "cuda",
            "source": "qwen3_tpu_torch/csrc/q8_matmul.cu",
            "replaces": f"qwen3_tpu/ops/pallas/q8_matmul.py:{source_line}",
            "launches": launches[kind],
            "max_abs_err": max(r["max_abs_diff"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in dec) * per_token,
            "plain_ms": sum(r["plain_ms"] for r in dec) * per_token,
            "bound_ms": total_bytes_ms,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in dec) else "operations",
            "library_ms": sum(r["library_ms"] for r in dec) * per_token,
        })
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    _, kind = phase_device(torch)
    sys.path.insert(0, str(HERE))
    try:
        import qwen3_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not next to this script: {e}")
    phase_build()
    rows = phase_kernels(torch)
    check_sampler(torch)
    workdir = HERE / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        path = write_checkpoint(workdir)
        launches, _ = phase_end_to_end(torch, path)
        phase_plain_path(torch, path)
        phase_profile(torch, path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernel_report(rows, launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
