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
   Qwen3-0.6B's main-path shapes, with device times (CUDA events, median of
   20 runs after warm-up), the bound and a library yardstick: the Q8_0 x
   Q8_0 matmuls (b = 1, 8, 64, 65, 256, 512, each row equal to the same
   row at b = 512; the tile path also summed per prefill block beside its
   epilogue floor) and the pallas-fast matmuls (b = 1, 8, 64, 128, 512, with the fp32 FMA floor beside the bound) bit for bit,
   the latter also across batch sizes; the pallas-fast and pallas-int8
   matmuls also summed over one forward step at b = 1, 8 and 64; the
   flash kernels, batched decode (B = 8 and 64) and two-segment flash
   within their tolerances; the pallas-int8 matmuls (b = 1, 8, 64, 256, 512)
   bit for bit and across batch sizes; the fused-prologue matmul for each
   (prologue, exact/fast) pair of the main path (b = 1, 8, 64, 512) against
   its plain version and the unfused kernel; the fixed-order norm kernel
   at qwen3-0.6b's norms (b = 1, 8, 512; bit-equal to its plain version in
   its order, a row's bits the same at every b, see phase_norm_kernel) and
   its folds, the residual add with the norm and the QK-norms with the rope
   (widths 128-4096, f32 and bf16, q/k views; bit-equal to their chains on
   the card, see phase_norm_folds);
   the KV row write at the B = 64 serving cache (f32, bf16; int32 and
   int64 positions; one kernel a call) and the untiled matmuls on [n, d]
   weights (b = 1, 8, 512; the exact one bit for bit, each row equal to
   the same row at b = 512 and to row 1's kernel on the transposed weights,
   its GEMV against its MMA tile path at b = 1-8 and the tile path's two
   fragment transposes at b = 64 and 512;
   the dequant one in f32 and bf16, pre- and post-scaled, within 1e-5 *
   max|plain|, its rows equal on every tile route), which only the tests
   call; every matmul kernel of the tensor-parallel paths at one tp = 2
   rank's shard shapes of qwen3-0.6b and qwen3-4b, bit for bit (qwen3-4b's
   w2 at 76 groups a k-tile), and the decode attention kernels at 4 and 1
   kv heads a rank (see phase_shard_kernels); every matmul kernel the 8B's
   paths can run at deepseek-r1-qwen3-8b's widths, b = 1 and 512, bit for
   bit, the layer matrices read at the last of 36 layers (see
   phase_8b_kernels); the sparse expert layer's five kernels (router,
   index, grouped w13 with its swiglu, grouped w2, combine) at
   Qwen3-30B-A3B's widths, 64 and 1024 rows, bit for bit against their
   plain twins and timed beside their bounds, a row's layer bits the same
   alone, and five launches a layer in a 2-layer 30B-width decode step
   (see phase_moe_kernels); the sampler's fixed-order sums (softmax sum, prefix
   sum) at V 512 and 151936 and B 1, 4, 8, 64, bit-equal to their ordered
   plain versions and a row's bits the same at every B, again on a second
   stream and back to back (their counters reset), then a row's token
   and sums in sample_tokens alone against in batches of 8 and 64, gated
   (see phase_sampler_kernel, sampler_batch_check); then the sampler on the
   card against its CPU run at the vocabulary of qwen3-0.6b (see
   check_sampler);
4. end to end: a synthetic qwen3-0.6b checkpoint (full width and depth,
   random weights from a seed) through the port's CLI main() with its
   defaults (--qmode pallas --kv-dtype int8 --attn auto --device cuda):
   greedy completion, a seeded completion twice (equal stdout), two chat
   turns, then past depth 8192; then the serving path through serve.main()
   with its defaults (--qmode pallas-fast --kv-dtype int8 --attn auto
   --batch 8 -c 1024), greedy and seeded twice (equal records), --batch 64
   -c 512, --batch 1 -c 32768 at depth, a BatchedChat, and batch
   invariance (see phase_serving); then the other modes (see phase_modes):
   the CLI with --qmode exact, bf16 and pallas-int8, the CLI and serve.py
   with QWEN3_TPU_FUSE=1 (the same tokens as without), serve.py --qmode
   pallas-int8; after each run the kernels' launch counts must equal what
   its forward passes need (the sampler's kernels once a sampled call);
   4b. the quality table on the same checkpoint at -c 1024, and at depths
   8192 and 16384 through tools/quality_depth.py, gated (see
   phase_quality); 4c. the host tools (model_check, tokenizer_check, the
   native encode against the Python one on every prompt, the CLI with --profile, see phase_host_tools); 4d. the DMA
   probe at qwen3-4b's full width (tools/probe_dma.py: the Q8_0 GEMV
   against the pure-read kernels, their checksums against the plain
   version, no rate past 1.05 x 3.35 TB/s; see phase_probe); 4e. the B = 1
   chunk whose loop stays on the card (decode_loop.decode_chunk) bit-equal
   to its host loop, with no synchronizing call inside a chunk (see
   phase_chunk_checks); then, counted as one path, Engine's fused program
   (greedy, seeded twice) and its side program against BatchedEngine(
   side_buffer=True) at B = 1 below and from depth 8192 (see
   phase_decode_programs), and the fused chunk at qwen3-4b's full width
   with bench.py's headline settings and at depth 8192, tok/s and the
   launches of every step (see phase_fused_4b); 4f. the tensor- and
   data-parallel paths, their ranks processes on this card over gloo (or
   NCCL with a card a rank): the CLI at --tp 2 (greedy, seeded twice, the
   prefill's logits against tp = 1), the fused chunk at qwen3-4b's full
   width at tp = 2, serve.py at --tp 2 and --dp 2 (greedy and seeded,
   every record equal to the single-rank server's), the CLI through
   --coordinator in two processes (see phase_tp_paths); 4g. counted as a
   path of its own, deepseek-r1-qwen3-8b end to end through
   tools/e2e_8b.py: its 8.1 GiB .bin generated from a seed, read back past
   4 GiB, served by serve.py (--batch 1, pallas, int8 KV, --attn flash,
   -c 32768, 96 greedy tokens) with the launch counts of 36 layers, stage
   times and peak device memory logged (see phase_e2e_8b);
5. the path against its plain version, step by step with the card's
   rounding decisions forced on the CPU (every op within 1e-5 of its max,
   every rounding step bit for bit, logits and argmax): a 64-token prefill
   block (and free-running within twice the CPU path's own spread under a
   one-ulp nudge of its input, see phase_plain_path), the flash block and
   step at depth 8192, one serving decode step at B = 8 (see
   phase_serving_plain) and a 64-token pallas-int8 block;
6. profile: torch.profiler over a warm greedy completion (one prefill
   block, 16 decode steps) in mode pallas, unfused and with the fused
   matmuls, and in mode pallas-int8, over one warm fused chunk of 32 steps
   at qwen3-0.6b and at qwen3-4b (ctx 1024, bf16 KV, greedy), and over one
   16-step serving chunk at B = 8 (-c 1024) (the B = 64 serving profile
   went: the benchmark's traced cells read what it read): device
   time by kernel (the matmul kernels' sum apart), kernels per step and the
   device's idle share.

The last two lines are a JSON object of per-kernel numbers and
{"ok": true, "device": {...}}. With --moe-only the script runs phases 1-2
and the expert layer's phase alone, and prints its kernels line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
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
# decode, serving's B = 8 in mode pallas, a ragged block, and the prefill
# ladder's blocks
BATCHES = (1, 8, 64, 65, 256, 512)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 peak outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak
# the fp32 pipe: 132 SMs x 128 lanes x 1.98 GHz (H100 SXM boost clock)
FP32_PIPE_OPS_PER_S = 132 * 128 * 1.98e9
# flash attention at qwen3-0.6b's shape, in the CLI's default 32768-row cache
FLASH_H, FLASH_KV, FLASH_D, FLASH_S = 16, 8, 128, 32768
FLASH_DEPTHS = (0, 255, 256, 8191, 16384, 32767)   # decode positions
FLASH_BLOCKS = (64, 512)                           # prefill block rows
FLASH_STARTS = (0, 8192, 32256)                    # prefill block starts
FLASH_TIMED = (("flash_decode", 8192, 1), ("flash_decode", 16384, 1),
               ("flash_decode", 32767, 1), ("flash_prefill", 8192, 64),
               ("flash_prefill", 8192, 512), ("flash_prefill", 32256, 512))
FLASH_DEPTH = 8192             # --attn auto switches to flash here
# the redesigned kernels' predecessors as PERF.md's kernel table records
# them (ms per token or per 28-layer block, as the kernels line counts; an
# NVIDIA H100 80GB HBM3 at 700 W): logged beside this run's times
BEFORE_MS = {"q8_q8_matmul_stacked": 1.349, "q8_q8_matmul_tiled": 0.138,
             "flash_prefill_gqa": 87.16, "flash_decode_gqa": 0.926,
             "flash_decode_gqa_two_segment": 0.934,
             "batched_decode_partial": 1.080, "q8_matmul_fused": 7.454,
             "q8_matmul_pallas": 3.743, "q8_q8_matmul_pallas": 2.163,
             "kv_write_rows": 0.0099, "sampler_softmax_sum": 0.0105,
             "sampler_prefix_sum": 0.0087}
# the profiles of PERF.md section 5 before the norm folds (NVIDIA H100 80GB
# HBM3 at 700 W), logged beside this run's: PyTorch kernels and device-busy
# ms a step, by profile
PROFILE_BEFORE = {
    "cli pallas": (3383.9, 6.20), "cli pallas fuse": (1832.5, 4.09),
    "cli pallas-int8": (2140.9, 5.07),
    "qwen3-0.6b fused chunk, ctx 1024": (2888.7, 5.21),
    "qwen3-4b fused chunk, ctx 1024": (3689.4, 9.52),
    "serving B=8": (2563.1, 6.13)}
# the Q8_0 x Q8_0 tile path's first design (b > 1), us a launch, as PERF.md
# records it (b = 64 / 256 / 512), logged beside this run's tile times
TILE_BEFORE_US = {
    "wqkv": {64: 44.8, 256: 48.7, 512: 88.7},
    "wo": {64: 87.8, 256: 81.8, 512: 80.1},
    "w13": {64: 44.5, 256: 64.3, 512: 118.6},
    "w2": {64: 125.9, 256: 117.2, 512: 115.5},
    "classifier": {64: 348.6, 256: 1331.9, 512: 2640.9}}
REPS, WARMUP = 20, 3
# the depth of the earlier paths, cut to leave the run room for the tensor-
# parallel paths (phase 4f) and the 8B path (phase 4g): tokens of the CLI's
# completions below depth 8192, of each request of the 16-prompt serving
# runs, and decode steps a profile covers (the CLI and the serving profiles)
E2E_TOKENS = 32
SERVE_TOKENS = 32
PROFILE_STEPS = 16
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
    entry = spill = ""
    for line in build.last_build_log.splitlines():
        if line.startswith("=="):
            log(f"ptxas: {line.strip()}")
        elif "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"ptxas: {entry}: {line.split(':', 1)[-1].strip()}; {spill}")
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


def matmul_bytes(b, n, d):
    """The bytes a Q8_0 x Q8_0 matmul must move: weights, their scales, the
    activations and their scales read once, the output written once."""
    return d * n + 4 * d * (n // G) + b * n + 4 * b * (n // G) + 4 * b * d


def bound_ms(b, n, d):
    """The least time for the function: bytes it must move (matmul_bytes)
    over the memory rate, or its int8 operations over the peak."""
    nbytes = matmul_bytes(b, n, d)
    ops = 2 * b * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def epilogue_floor_ms(b, n, d):
    """The tile path's second floor: its ordered fp32 epilogue, 4 fp32-pipe
    operations (the dot's conversion, two products, one sum) per (row,
    column, group), over the card's fp32 pipe."""
    return 1e3 * 4 * b * d * (n // G) / FP32_PIPE_OPS_PER_S


def tile_block(rows, b):
    """The tile path's sums over one forward pass's layer matrices at b rows
    (a prefill block, or a serving step in mode pallas): the four stacked
    matrices x 28 layers (the classifier runs on one row); before_ms is
    PR 1's design as PERF.md records it, for the log only."""
    mine = [r for r in rows if r["b"] == b and r["kernel"] == "stacked"]
    out = {"b": b, "layer_matmuls": 4 * L}
    for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "epilogue_floor_ms"):
        out[key] = L * sum(r[key] for r in mine)
    if all(r.get("before_us") for r in mine):
        out["before_ms"] = L * sum(r["before_us"] for r in mine) / 1e3
    return out


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
        x_all = torch.randn(max(BATCHES), n, device=dev, generator=gen)
        xq_all, xs_all = quantize_act(x_all, G)
        widest = None
        for b in sorted(BATCHES, reverse=True):
            x = x_all[:b].contiguous()
            xq, xs = xq_all[:b].contiguous(), xs_all[:b].contiguous()
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
            # a row's bits do not depend on its batch-mates: every b's rows
            # equal the same rows of the widest call (b = 1: the GEMV)
            got = kernel(L - 1)
            if widest is None:
                widest = got
            torch.cuda.synchronize()
            if not torch.equal(got, widest[:b]):
                fail(f"{name} b={b}: rows differ from the same rows at "
                     f"b={max(BATCHES)}")
            k_ms = device_ms(torch, kernel)
            p_ms = device_ms(torch, plain)
            l_ms = device_ms(torch, library)
            bnd, by = bound_ms(b, n, d)
            row = dict(matrix=name, kernel="stacked" if stacked else "tiled",
                       b=b, n=n, d=d, layers_cycled=n_layers,
                       max_abs_diff=err, kernel_ms=k_ms, bound_ms=bnd,
                       bound_by=by, plain_ms=p_ms, library_ms=l_ms,
                       tb_s=matmul_bytes(b, n, d) / k_ms / 1e9)
            if b > 1:
                shape, splits = qm.plan_q8q8(b, n, d, G)
                row.update(epilogue_floor_ms=epilogue_floor_ms(b, n, d),
                           tile_rows=qm.TILE_ROWS[shape], k_splits=splits,
                           before_us=TILE_BEFORE_US[name].get(b))
            rows.append(row)
            log("kernel " + json.dumps(row))
        del w_q, w_s, w_bf
        torch.cuda.empty_cache()
    rows.sort(key=lambda r: (list(MATRICES).index(r["matrix"]), r["b"]))
    for b in (8, 64, 512):
        log("q8q8 block " + json.dumps(tile_block(rows, b)))
    log("library_ms = torch.nn.functional.linear on bf16 activations and "
        "the weights dequantized once to bf16 (no single PyTorch call "
        "computes the grouped int8 function); timed here, never called by "
        "the port")
    return rows


def attn_bound_ms(q_rows, rows_read, score_pairs, fast=False, outputs=None,
                  tf32_mmas=0, heads=FLASH_H, kv_heads=FLASH_KV):
    """The least time for one attention launch: the bytes it must move (the
    f32 queries, the int8 K/V values and f32 scales of the rows it reads,
    once each, and `outputs` f32 values, by default one a query value) over
    the memory rate, or its operations (2 for q . k and 2 for p v per score
    pair and head dim) over the peak of the dots' type: bf16 when `fast`,
    `tf32_mmas` TF32 tensor-core products each when it is nonzero (the
    flash prefill's split fp32), else fp32 outside the tensor cores.
    `heads`/`kv_heads`: qwen3-0.6b's unless a tensor-parallel shard's."""
    if outputs is None:
        outputs = q_rows * heads * FLASH_D
    nbytes = 4 * q_rows * heads * FLASH_D + 4 * outputs + \
        2 * rows_read * kv_heads * (FLASH_D + 4)
    ops = 4 * score_pairs * heads * FLASH_D
    if tf32_mmas:
        ops, peak = tf32_mmas * ops, TF32_OPS_PER_S
    else:
        peak = BF16_OPS_PER_S if fast else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_cache(torch, dtype, layers, gen):
    """K and V for `layers` layers of one slot at FLASH_S rows, random
    normal; int8 through the port's KV encode (values and scales)."""
    from qwen3_tpu_torch.runtime import kvcache as kvc

    out = []
    for _ in range(2):
        x = torch.randn(layers, 1, FLASH_S, FLASH_KV, FLASH_D, device="cuda",
                        generator=gen)
        if dtype == "int8":
            out.append(kvc.quantize_heads(x))
        else:
            out.append((x.to(getattr(torch, dtype)), None))
        del x
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def phase_flash_kernels(torch):
    """Both flash kernels against their plain versions on the card in the
    three KV dtypes, in a 32768-row cache at qwen3-0.6b's attention shape
    (16 heads over 8 kv heads of 128): decode at depths 0, 255, 256, 8191,
    16384 and 32767, prefill blocks of 64 and 512 rows starting at 0, 8192
    and 32256, each within 2e-5 * max(1, max|plain|) (the JAX package's
    flash tolerance); the prefill also equal bit for bit across two calls,
    and within the tolerance with its grid sized for the whole cache (no
    `live`). Then times for int8 (the main path's cache) over a
    28-layer cache, a layer per run, so that no run finds its rows in L2:
    the kernel, its plain version and the library yardstick
    (scaled_dot_product_attention on K/V dequantized once to f32)."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    err = {"flash_decode": 0.0, "flash_prefill": 0.0}

    def check(name, got, want, label):
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name} {label}: non-finite kernel output")
        diff = (got - want).abs().max().item()
        tol = 2e-5 * max(1.0, want.abs().max().item())
        err[name] = max(err[name], diff)
        if diff > tol:
            fail(f"{name} {label}: kernel vs plain max_abs_diff {diff:.3e} "
                 f"> {tol:.3e}")
        return diff

    for dtype in ("float32", "bfloat16", "int8"):
        k, v, ks, vs = flash_cache(torch, dtype, 1, gen)
        kl, vl = k[0], v[0]
        ksl = None if ks is None else ks[0]
        vsl = None if vs is None else vs[0]
        diffs = []
        for depth in FLASH_DEPTHS:
            q = torch.randn(1, FLASH_H, FLASH_D, device="cuda", generator=gen)
            pos = torch.tensor([depth], dtype=torch.int32, device="cuda")
            want = fd.flash_decode_plain(q, kl, vl, pos, ksl, vsl,
                                         live=depth + 1)
            got = fd.flash_decode_gqa(q, kl, vl, pos, ksl, vsl,
                                      live=depth + 1)
            diffs.append(check("flash_decode", got, want,
                               f"{dtype} depth {depth}"))
            # one launch a call: the last block of a slot's kv head combines
            # in tile order and resets its counter, so a second call repeats
            # the bits and every counter is back at zero
            again = fd.flash_decode_gqa(q, kl, vl, pos, ksl, vsl,
                                        live=depth + 1)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"flash_decode {dtype} depth {depth}: two calls differ")
            if fd.decode_counters(got.device, 1).any():
                fail(f"flash_decode {dtype} depth {depth}: a completion "
                     f"counter was left nonzero")
        for t in FLASH_BLOCKS:
            for start in FLASH_STARTS:
                q = torch.randn(1, t, FLASH_H, FLASH_D, device="cuda",
                                generator=gen)
                qpos = torch.arange(start, start + t, dtype=torch.int32,
                                    device="cuda")
                want = fd.flash_prefill_plain(q, kl, vl, qpos, ksl, vsl,
                                              live=start + t)
                got = fd.flash_prefill_gqa(q, kl, vl, qpos, ksl, vsl,
                                           live=start + t)
                diffs.append(check("flash_prefill", got, want,
                                   f"{dtype} T {t} start {start}"))
                # the segments' partials combine in a fixed order, and a
                # grid sized without `live` (the whole cache) reads the same
                again = fd.flash_prefill_gqa(q, kl, vl, qpos, ksl, vsl,
                                             live=start + t)
                whole = fd.flash_prefill_gqa(q, kl, vl, qpos, ksl, vsl)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"flash_prefill {dtype} T {t} start {start}: two "
                         f"calls differ")
                check("flash_prefill", whole, want,
                      f"{dtype} T {t} start {start}, grid without live")
                # a `live` below the positions sizes a smaller grid, whose
                # segments grow to hold every visible chunk
                short = fd.flash_prefill_gqa(q, kl, vl, qpos, ksl, vsl,
                                             live=max(1, start // 2))
                check("flash_prefill", short, want,
                      f"{dtype} T {t} start {start}, live "
                      f"{max(1, start // 2)}")
        log(f"flash kernels vs plain, {dtype} KV: max_abs_diff per case "
            f"(decode at {list(FLASH_DEPTHS)}, then prefill T x start "
            f"{[(t, s) for t in FLASH_BLOCKS for s in FLASH_STARTS]}): "
            f"{[float(f'{d:.3e}') for d in diffs]}")
        del k, v, ks, vs, kl, vl, ksl, vsl
        torch.cuda.empty_cache()

    k, v, ks, vs = flash_cache(torch, "int8", L, gen)
    for kind, depth, t in FLASH_TIMED:
        n = depth + t if kind == "flash_prefill" else depth + 1
        # the library yardstick's K/V: each layer's live rows dequantized
        # once to f32, heads first
        kf = (k[:, 0, :n].float() * ks[:, 0, :n, :, None]).transpose(1, 2)
        vf = (v[:, 0, :n].float() * vs[:, 0, :n, :, None]).transpose(1, 2)
        if kind == "flash_decode":
            q = torch.randn(1, FLASH_H, FLASH_D, device="cuda",
                            generator=gen)
            pos = torch.tensor([depth], dtype=torch.int32, device="cuda")
            mask = None
            pairs = n

            def kernel(i, q=q, pos=pos, n=n):
                return fd.flash_decode_gqa(q, k[i % L], v[i % L], pos,
                                           ks[i % L], vs[i % L], live=n)

            def plain(i, q=q, pos=pos, n=n):
                return fd.flash_decode_plain(q, k[i % L], v[i % L], pos,
                                             ks[i % L], vs[i % L], live=n)

            q_lib = q[:, :, None, :]                     # [1, H, 1, D]
        else:
            q = torch.randn(1, t, FLASH_H, FLASH_D, device="cuda",
                            generator=gen)
            pos = torch.arange(depth, depth + t, dtype=torch.int32,
                               device="cuda")
            mask = (torch.arange(n, device="cuda")[None, :]
                    <= pos[:, None])                     # [T, n]
            pairs = int((pos.long() + 1).sum())

            def kernel(i, q=q, pos=pos, n=n):
                return fd.flash_prefill_gqa(q, k[i % L], v[i % L], pos,
                                            ks[i % L], vs[i % L], live=n)

            def plain(i, q=q, pos=pos, n=n):
                return fd.flash_prefill_plain(q, k[i % L], v[i % L], pos,
                                              ks[i % L], vs[i % L], live=n)

            q_lib = q.transpose(1, 2)                    # [1, H, T, D]

        def library(i, q_lib=q_lib, mask=mask):
            return F.scaled_dot_product_attention(
                q_lib, kf[i % L][None], vf[i % L][None], attn_mask=mask,
                enable_gqa=True)

        got = kernel(0)
        check(kind, got, plain(0), f"int8 timed case depth {depth} T {t}")
        lib = library(0)
        lib = lib[:, :, 0] if kind == "flash_decode" else lib.transpose(1, 2)
        lib_diff = (lib - got).abs().max().item()
        # the prefill's dots run as two TF32 MMAs a product on the int8
        # cache (csrc/flash_decode.cu), the decode's in fp32 on CUDA cores
        bnd, by = attn_bound_ms(t, n, pairs,
                                tf32_mmas=2 * (kind == "flash_prefill"))
        row = dict(kernel=kind, depth=depth, T=t, rows_read=n,
                   kernel_ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain),
                   library_ms=device_ms(torch, library), bound_ms=bnd,
                   bound_by=by, library_vs_kernel_max_abs_diff=lib_diff)
        if kind == "flash_prefill":
            # the grid's blocks with work, the fp32-equivalent rate, and the
            # bound of the same operations in fp32 on CUDA cores
            tq = fd.prefill_tq(t, FLASH_H // FLASH_KV)
            seg, n_seg = fd.plan_prefill(t, tq, FLASH_S, FLASH_KV, 1, n)
            blocks = FLASH_KV * sum(
                len(fd.prefill_segments(
                    min((depth + t0 + tq - 1) // fd.PREFILL_CHUNK + 1,
                        FLASH_S // fd.PREFILL_CHUNK), seg, n_seg))
                for t0 in range(0, t, tq))
            row.update(blocks=blocks, seg_chunks=seg, n_seg=n_seg,
                       tflop_s=4 * pairs * FLASH_H * FLASH_D
                       / row["kernel_ms"] / 1e9,
                       fp32_bound_ms=attn_bound_ms(t, n, pairs)[0])
        rows.append(row)
        log("flash " + json.dumps(row))
        del kf, vf
        torch.cuda.empty_cache()
    log("flash library_ms = scaled_dot_product_attention(enable_gqa=True, a "
        "boolean position mask for prefill) on K/V dequantized once to f32: "
        "it reads 4 bytes per cached value where the kernels read 1 and a "
        "scale per row; timed here, never called by the port")
    del k, v, ks, vs
    torch.cuda.empty_cache()
    return rows, err


FAST_BATCHES = (1, 8, 64, 128, 512)  # decode at B = 1 and 8, B = 64, the
                                     # 128-row admission block, a wide one
# qwen3-4b's layer matrices (n, d) at two of the benchmark's prefill blocks
MATRICES_4B = {"wqkv": (2560, 6144), "wo": (4096, 2560),
               "w13": (2560, 19456), "w2": (9728, 2560)}
FAST_BATCHES_4B = (128, 512)
# batched decode partials: (slots, bucket), the serving engine's cache rows
# for -c 1024 and -c 512 (+ 32 side rows, padded to 128)
BATCHED_CASES = ((8, 1152), (64, 640))
SIDE_C = 32                    # the serving decode chunk
TWO_SEG_BASES = (0, 8192, 32736)
TWO_SEG_ROWS = 33024           # -c 32768 + 32, padded to 256


STEP_BATCHES = (1, 8, 64)      # the per-step sums of the fast and int8 phases


def step_lines(label, rows, keys=("kernel_ms", "library_ms", "bound_ms")):
    """Log one forward step's sums at each b in STEP_BATCHES: the four
    layer matrices x 28 plus the classifier, for each of `keys`."""
    for b in STEP_BATCHES:
        mine = [r for r in rows if r["b"] == b]
        step = {key: sum(r[key] * (1 if r["matrix"] == "classifier" else L)
                         for r in mine) for key in keys}
        log(f"{label} step " + json.dumps(dict(b=b, **step)))


def fast_bound_ms(b, n, d):
    """The least time for a fast matmul: the int8 weights and their f32
    scales, the bf16 activations read once and the f32 output written once,
    over the memory rate; or its operations on bf16 operands over the bf16
    peak."""
    nbytes = d * n + 4 * d * (n // G) + 2 * b * n + 4 * b * d
    ops = 2 * b * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def value_tol(want, mag, fast):
    """The batched decode kernel's tolerance for acc against its plain
    version, per element: 2e-5 * max(1, max|plain|) for the fp32 sums in
    another order, plus under `fast` 2^-8 * mag, mag = sum_s p_s * |v_s *
    vs_s| of that element (batched_decode_magnitude). Under `fast` the value
    dot's operand p * vs is rounded to bf16, by at most 2^-8 of itself; the
    kernel's p is relative to the running max of the rows its lane group
    has read so far, the plain version's to that of the Pallas kernel's
    tiles, so the two round each term independently. Their gap could reach
    2^-7 * mag only if every term's two roundings fell at opposite
    extremes; 2^-8 * mag is half that."""
    tol = 2e-5 * max(1.0, want.abs().max().item())
    return tol + 2.0 ** -8 * mag if fast else tol


def partials_over(got, want, acc_tol):
    """How much of their tolerances the kernel's (acc, m, l) use: {name:
    (max_abs_diff, max of diff / tolerance)}; acc_tol a number or one per
    element, m and l 2e-5 * max(1, max|plain|) over the slots with rows (a
    slot without rows has m = finfo.min, which must match exactly)."""
    out, live = {}, want[2] > 0
    for name, a, w_ in zip(("acc", "m", "l"), got, want):
        scale = w_[live].abs().max().item() if live.any() else 0.0
        tol = acc_tol if name == "acc" else 2e-5 * max(1.0, scale)
        d = (a - w_).abs()
        out[name] = (d.max().item(), (d / tol).max().item())
    return out


def phase_fast_kernels(torch):
    """The pallas-fast matmul kernels against their plain version on the
    card at qwen3-0.6b's matrices, b in FAST_BATCHES, bit for bit; each row
    of every b equal, bit for bit, to the same row in the b = 512 call (the
    kernels' batch invariance); times as phase_kernels'."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []
    for name, (n, d) in MATRICES.items():
        stacked = name != "classifier"
        lead = (L,) if stacked else ()
        w_q = torch.randint(-127, 128, lead + (d, n), dtype=torch.int8,
                            device=dev, generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(lead + (d, n // G), device=dev,
                                             generator=gen))
        w_bf = (w_q.float().reshape(*lead, d, n // G, G)
                * w_s[..., None]).reshape(*lead, d, n).to(torch.bfloat16)
        x_all = torch.randn(max(FAST_BATCHES), n, device=dev,
                            generator=gen).to(torch.bfloat16)
        layer = L - 1

        def call(x, i=layer):
            if stacked:
                return qm.q8_matmul_stacked_fast(x, w_q, w_s, i % L, G)
            return qm.q8_matmul_tiled_fast(x, w_q, w_s, G)

        widest = call(x_all)
        for b in FAST_BATCHES:
            x = x_all[:b].contiguous()

            def kernel(i, x=x):
                return call(x, i)

            def plain(i, x=x):
                if stacked:
                    return qm.q8_fast_matmul_plain(x, w_q[i % L], w_s[i % L],
                                                   G)
                return qm.q8_fast_matmul_plain(x, w_q, w_s, G)

            def library(i, x=x):
                return F.linear(x, w_bf[i % L] if stacked else w_bf)

            got, want = kernel(layer), plain(layer)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"fast {name} b={b}: non-finite kernel output")
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                fail(f"fast {name} b={b}: kernel != plain (max_abs_diff "
                     f"{err:.3e})")
            if not torch.equal(got, widest[:b]):
                fail(f"fast {name} b={b}: rows differ from the same rows "
                     f"at b={max(FAST_BATCHES)}")
            bnd, by = fast_bound_ms(b, n, d)
            row = dict(matrix=name, kernel="stacked_fast" if stacked
                       else "tiled_fast", b=b, n=n, d=d, max_abs_diff=err,
                       kernel_ms=device_ms(torch, kernel),
                       plain_ms=device_ms(torch, plain, reps=5),
                       library_ms=device_ms(torch, library), bound_ms=bnd,
                       bound_by=by,
                       fma_floor_ms=1e3 * 2 * b * n * d / FP32_OPS_PER_S)
            rows.append(row)
            log("fast " + json.dumps(row))
        del w_q, w_s, w_bf
        torch.cuda.empty_cache()
    step_lines("fast", rows, ("kernel_ms", "library_ms", "bound_ms",
                              "fma_floor_ms"))
    fast_4b_kernels(torch, gen)
    log(f"fast matmuls: every row bit-equal at b in {list(FAST_BATCHES)}; "
        "library_ms = torch.nn.functional.linear on bf16 with the weights "
        "dequantized once to bf16; fma_floor_ms = the fp32 FMAs over the "
        "67 TFLOP/s outside the tensor cores, the floor under the bit rule "
        "(the kernel sums each group in k order, which an MMA does not)")
    return rows


def fast_4b_kernels(torch, gen):
    """The fast matmul at qwen3-4b's layer matrices, b in FAST_BATCHES_4B,
    on plan_fast's route: bit-equal to the plain version and to the same
    rows at the widest b, timed beside F.linear and the fp32 FMAs' floor
    (one plain call a row, not timed: 1.7 s of the phase on an H100)."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.tools.fast_routes import route_name

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (n, d) in MATRICES_4B.items():
        w_q = torch.randint(-127, 128, (d, n), dtype=torch.int8, device=dev,
                            generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(d, n // G, device=dev,
                                             generator=gen))
        w_bf = (w_q.float().reshape(d, n // G, G) * w_s[..., None]).reshape(
            d, n).to(torch.bfloat16)
        x_all = torch.randn(max(FAST_BATCHES_4B), n, device=dev,
                            generator=gen).to(torch.bfloat16)
        widest = qm.q8_matmul_tiled_fast(x_all, w_q, w_s, G)
        for b in FAST_BATCHES_4B:
            x = x_all[:b].contiguous()
            got = qm.q8_matmul_tiled_fast(x, w_q, w_s, G)
            if not torch.equal(got, qm.q8_fast_matmul_plain(x, w_q, w_s, G)):
                fail(f"fast qwen3-4b {name} b={b}: kernel != plain")
            if not torch.equal(got, widest[:b]):
                fail(f"fast qwen3-4b {name} b={b}: rows differ from the "
                     f"same rows at b={max(FAST_BATCHES_4B)}")
            route = qm.plan_fast(b, n, d, G, sms)
            ms = device_ms(torch,
                           lambda i, x=x: qm.q8_matmul_tiled_fast(x, w_q,
                                                                  w_s, G))
            floor = 1e3 * 2 * b * n * d / FP32_OPS_PER_S
            row = dict(matrix=name, model="qwen3-4b", b=b, n=n, d=d,
                       route=route_name(route),
                       kernel_ms=ms, fma_floor_ms=floor,
                       over_floor=ms / floor,
                       library_ms=device_ms(torch,
                                            lambda i, x=x: F.linear(x, w_bf)),
                       bound_ms=fast_bound_ms(b, n, d)[0])
            log("fast 4b " + json.dumps(row))
        del w_q, w_s, w_bf, x_all, widest
        torch.cuda.empty_cache()
    log(f"fast qwen3-4b matrices: {time.perf_counter() - t0:.1f} s")


def serving_cache(torch, layers, slots, rows, gen):
    """int8 K and V [layers, slots, rows, 8, 128] through the port's KV
    encode, with their scales."""
    from qwen3_tpu_torch.runtime import kvcache as kvc

    out = []
    for _ in range(2):
        x = torch.randn(layers, slots, rows, FLASH_KV, FLASH_D, device="cuda",
                        generator=gen)
        out.append(kvc.quantize_heads(x))
        del x
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def batched_negative_checks(torch, bd, B, bucket, q, k, v, layer, lim, ks,
                            vs, mag, want):
    """That the batched decode check would catch a kernel without the
    `fast` roundings. The kernel with fast=False against the plain version
    with fast=True must fail value_tol. Then the frame-free case, q = 0:
    every live score is 0 and every p exactly 1 in any frame, so both round
    the same p * vs = vs and acc must agree to 2e-5 * max(1, max|plain|)
    (fp32 sums in another order); the plain version with fast=False (no
    rounding of p * vs) must fail that bound, and so must the kernel with
    fast=False."""
    def call(fn, q_, fast):
        return fn(q_, k, v, layer, lim, ks, vs, bucket=bucket, fast=fast)

    label = f"batched_decode B={B} layer {layer}"
    unrounded = call(bd.batched_decode_partial, q, False)
    over = partials_over(unrounded, want, value_tol(want[0], mag, True))
    if max(used for _, used in over.values()) <= 1.0:
        fail(f"{label}: the kernel with fast=False passes the fast check "
             f"{over}")
    zero = torch.zeros_like(q)
    want0 = call(bd.batched_decode_plain, zero, True)
    tol0 = value_tol(want0[0], None, False)
    got0 = call(bd.batched_decode_partial, zero, True)
    over0 = partials_over(got0, want0, tol0)
    bad = {name: partials_over(call(fn, zero, False), want0, tol0)["acc"]
           for name, fn in (("plain", bd.batched_decode_plain),
                            ("kernel", bd.batched_decode_partial))}
    torch.cuda.synchronize()
    log(f"{label} negative checks: the kernel with fast=False against the "
        f"fast plain version {over}; at q = 0 the fast kernel {over0}, "
        f"acc with fast=False {bad}")
    if max(used for _, used in over0.values()) > 1.0:
        fail(f"{label}: at q = 0 the fast kernel differs from its plain "
             f"version {over0}")
    if min(used for _, used in bad.values()) <= 1.0:
        fail(f"{label}: at q = 0 acc without the rounding of p * vs passes "
             f"the fast check {bad}")


def phase_batched_kernels(torch):
    """batched_decode_partial against its plain version on the card at
    qwen3-0.6b's attention shape, int8 K/V, fast on and off, for B = 8 over
    a 1152-row bucket and B = 64 over 640 rows, row limits spread over the
    bucket (and one slot at 0 rows); then the two-segment flash kernel at
    B = 1 over a 33024-row cache at base positions 0, 8192 and 32736 with a
    32-row side buffer. Timed a layer per run over
    28 layers; the library yardstick is scaled_dot_product_attention
    (enable_gqa=True) with a per-slot mask on K/V dequantized once. Held to
    value_tol (acc, per element) and 2e-5 * max(1, max|plain|) (m, l, and
    the two-segment output), with batched_negative_checks under `fast`."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import batched_decode as bd
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows, err = [], {"batched_decode_partial": 0.0,
                     "flash_decode_gqa_two_segment": 0.0}
    for B, bucket in BATCHED_CASES:
        k, v, ks, vs = serving_cache(torch, L, B, bucket, gen)
        q = torch.randn(B, FLASH_H, FLASH_D, device="cuda", generator=gen)
        lim_host = [0] + [int(x) for x in torch.linspace(
            1, bucket, B - 1).round().tolist()]
        lim = torch.tensor(lim_host, dtype=torch.int32, device="cuda")
        n = max(lim_host)
        # the yardstick's K/V: each layer's rows dequantized once to f32
        kf = (k[:, :, :n].float() * ks[:, :, :n, :, None]).transpose(2, 3)
        vf = (v[:, :, :n].float() * vs[:, :, :n, :, None]).transpose(2, 3)
        mask = (torch.arange(n, device="cuda")[None, :]
                < lim[:, None])[:, None, None, :]        # [B, 1, 1, n]
        for fast in (False, True):
            def kernel(i, fast=fast):
                return bd.batched_decode_partial(q, k, v, i % L, lim, ks, vs,
                                                 bucket=bucket, fast=fast)

            def plain(i, fast=fast):
                return bd.batched_decode_plain(q, k, v, i % L, lim, ks, vs,
                                               bucket=bucket, fast=fast)

            def library(i):
                return F.scaled_dot_product_attention(
                    q[:, :, None], kf[i % L], vf[i % L], attn_mask=mask,
                    enable_gqa=True)

            diff = 0.0
            for layer in (0, L - 1):
                got, want = kernel(layer), plain(layer)
                again = kernel(layer)
                torch.cuda.synchronize()
                if not all(torch.isfinite(t).all() for t in got):
                    fail(f"batched_decode B={B} fast={fast}: non-finite")
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    fail(f"batched_decode B={B} fast={fast}: two calls "
                         f"differ")
                mag = bd.batched_decode_magnitude(q, k, v, layer, lim, ks,
                                                  vs, bucket=bucket)
                over = partials_over(got, want, value_tol(want[0], mag, fast))
                diff = max([diff] + [d for d, _ in over.values()])
                log(f"batched_decode B={B} fast={fast} layer {layer}: "
                    f"(max_abs_diff, share of the tolerance) {over}")
                for name, (d, used) in over.items():
                    if used > 1.0:
                        fail(f"batched_decode B={B} fast={fast} layer "
                             f"{layer}: {name} differs by {d:.3e}, "
                             f"{used:.2f} times its tolerance")
                if fast:
                    batched_negative_checks(torch, bd, B, bucket, q, k, v,
                                            layer, lim, ks, vs, mag, want)
            err["batched_decode_partial"] = max(
                err["batched_decode_partial"], diff)
            read = sum(lim_host)
            bnd, by = attn_bound_ms(B, read, read, fast,
                                    B * FLASH_H * (FLASH_D + 2))
            row = dict(kernel="batched_decode_partial", B=B, bucket=bucket,
                       fast=fast, rows_read=read, max_abs_diff=diff,
                       kernel_ms=device_ms(torch, kernel),
                       plain_ms=device_ms(torch, plain, reps=5),
                       library_ms=device_ms(torch, library), bound_ms=bnd,
                       bound_by=by)
            rows.append(row)
            log("batched " + json.dumps(row))
        del k, v, ks, vs, kf, vf
        torch.cuda.empty_cache()

    k, v, ks, vs = serving_cache(torch, L, 1, TWO_SEG_ROWS, gen)
    sk, sv, sks, svs = serving_cache(torch, L, 1, SIDE_C, gen)
    for base in TWO_SEG_BASES:
        off = SIDE_C - 1 - base % 7
        q = torch.randn(1, FLASH_H, FLASH_D, device="cuda", generator=gen)
        bt = torch.tensor([base], dtype=torch.int32, device="cuda")
        ot = torch.tensor([off], dtype=torch.int32, device="cuda")
        live = base

        def kernel(i, q=q, bt=bt, ot=ot, live=live):
            return fd.flash_decode_gqa_two_segment(
                q, k[i % L], v[i % L], sk[i % L], sv[i % L], bt, ot,
                ks[i % L], vs[i % L], sks[i % L], svs[i % L], live=live)

        def plain(i, q=q, bt=bt, ot=ot, live=live):
            return fd.flash_decode_two_segment_plain(
                q, k[i % L], v[i % L], sk[i % L], sv[i % L], bt, ot,
                ks[i % L], vs[i % L], sks[i % L], svs[i % L], live=live)

        # the yardstick's K/V: main rows < base then side rows <= off,
        # dequantized once to f32, heads first
        def deq(a, s, stop):
            return (a[:, 0, :stop].float() * s[:, 0, :stop, :, None])

        kf = torch.cat([deq(k, ks, base), deq(sk, sks, off + 1)],
                       dim=1).transpose(1, 2)
        vf = torch.cat([deq(v, vs, base), deq(sv, svs, off + 1)],
                       dim=1).transpose(1, 2)

        def library(i, q=q, kf=kf, vf=vf):
            return F.scaled_dot_product_attention(
                q[:, :, None], kf[i % L][None], vf[i % L][None],
                enable_gqa=True)

        got, want = kernel(0), plain(0)
        again = kernel(0)
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        tol = 2e-5 * max(1.0, want.abs().max().item())
        if not torch.isfinite(got).all() or diff > tol:
            fail(f"two-segment flash at base {base}: max_abs_diff "
                 f"{diff:.3e} > {tol:.3e}")
        if not torch.equal(got, again):
            fail(f"two-segment flash at base {base}: two calls differ")
        err["flash_decode_gqa_two_segment"] = max(
            err["flash_decode_gqa_two_segment"], diff)
        read = base + off + 1
        bnd, by = attn_bound_ms(1, read, read)
        row = dict(kernel="flash_decode_gqa_two_segment", base=base,
                   offset=off, rows_read=read, max_abs_diff=diff,
                   kernel_ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain, reps=5),
                   library_ms=device_ms(torch, library), bound_ms=bnd,
                   bound_by=by)
        rows.append(row)
        log("two_segment " + json.dumps(row))
        del kf, vf
    del k, v, ks, vs, sk, sv, sks, svs
    torch.cuda.empty_cache()
    log("batched/two-segment library_ms = scaled_dot_product_attention("
        "enable_gqa=True, a per-slot row mask) on K/V dequantized once to "
        "f32; timed here, never called by the port")
    return rows, err


INT8_BATCHES = (1, 8, 64, 256, 512)  # decode, the serve default, prefill
FUSED_BATCHES = (1, 8, 64, 512)
# the fused matmul's prologue before each matrix on the main path
FUSED_PROLOGUES = {"wqkv": "norm", "wo": "none", "w13": "norm",
                   "w2": "swiglu", "classifier": "norm"}


def weight_stack(torch, name, gen):
    """Random Q8_0 weights of one qwen3-0.6b matrix on the card: [L, d, n]
    (the classifier [d, n]) int8 with f32 group scales, and the library
    yardstick's copy dequantized once to bf16."""
    n, d = MATRICES[name]
    lead = (L,) if name != "classifier" else ()
    w_q = torch.randint(-127, 128, lead + (d, n), dtype=torch.int8,
                        device="cuda", generator=gen)
    w_s = 0.02 / 127 * (0.5 + torch.rand(lead + (d, n // G), device="cuda",
                                         generator=gen))
    w_bf = (w_q.float().reshape(*lead, d, n // G, G)
            * w_s[..., None]).reshape(*lead, d, n).to(torch.bfloat16)
    return w_q, w_s, w_bf


def int8_bound_ms(b, n, d):
    """The least time for a pallas-int8 matmul: the int8 weights and their
    f32 scales, the f32 activations read once and the f32 output written
    once, over the memory rate; or its int8 operations over the int8
    peak."""
    nbytes = d * n + 4 * d * (n // G) + 4 * b * n + 4 * b * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * b * n * d / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_int8_kernels(torch):
    """The pallas-int8 matmul kernels (q8i8 stacked and tiled) against
    their plain version on the card at qwen3-0.6b's matrices, b in
    INT8_BATCHES, bit for bit; each row of every b equal, bit for bit, to
    the same row in the b = 512 call. Times as phase_kernels' (the wrapper:
    its quantization kernel, which quantizes the activations per (row,
    k-tile) as the JAX function does with XLA ops, and the matmul)."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rows = []
    for name, (n, d) in MATRICES.items():
        stacked = name != "classifier"
        w_q, w_s, w_bf = weight_stack(torch, name, gen)
        x_all = torch.randn(max(INT8_BATCHES), n, device="cuda",
                            generator=gen)

        def call(x, i):
            if stacked:
                return qm.q8i8_matmul_stacked(x, w_q, w_s, i % L, G)
            return qm.q8i8_matmul_tiled(x, w_q, w_s, G)

        widest = call(x_all, L - 1)
        for b in INT8_BATCHES:
            x = x_all[:b].contiguous()

            def kernel(i, x=x):
                return call(x, i)

            def plain(i, x=x):
                return qm.q8i8_matmul_plain(
                    x, w_q[i % L] if stacked else w_q,
                    w_s[i % L] if stacked else w_s, G)

            def library(i, x=x):
                return F.linear(x.to(torch.bfloat16),
                                w_bf[i % L] if stacked else w_bf)

            err = 0.0
            for layer in ((0, L - 1) if stacked else (0,)):
                got, want = kernel(layer), plain(layer)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"int8 {name} b={b}: non-finite kernel output")
                err = max(err, (got - want).abs().max().item())
                if not torch.equal(got, want):
                    fail(f"int8 {name} b={b} layer={layer}: kernel != plain "
                         f"(max_abs_diff {err:.3e})")
            if not torch.equal(kernel(L - 1), widest[:b]):
                fail(f"int8 {name} b={b}: rows differ from the same rows at "
                     f"b={max(INT8_BATCHES)}")
            bnd, by = int8_bound_ms(b, n, d)
            row = dict(matrix=name, kernel="stacked_int8" if stacked
                       else "tiled_int8", b=b, n=n, d=d, max_abs_diff=err,
                       kernel_ms=device_ms(torch, kernel),
                       plain_ms=device_ms(torch, plain, reps=3),
                       library_ms=device_ms(torch, library), bound_ms=bnd,
                       bound_by=by)
            rows.append(row)
            log("int8 " + json.dumps(row))
        del w_q, w_s, w_bf
        torch.cuda.empty_cache()
    step_lines("int8", rows)
    log(f"int8 matmuls: every row bit-equal at b in {list(INT8_BATCHES)}; "
        "ms includes the activation quantization; library_ms = "
        "torch.nn.functional.linear on bf16 with the weights dequantized "
        "once to bf16")
    return rows


def fused_bound_ms(b, n, d, prologue, exact):
    """The least time for a fused matmul: the int8 weights and their f32
    scales, the f32 raw activations (both halves for swiglu), the norm
    weights and row factors, read once, and the f32 output written once,
    over the memory rate; or its operations (int8 when exact, else bf16)
    over their peak."""
    width = 2 * n if prologue == "swiglu" else n
    nbytes = d * n + 4 * d * (n // G) + 4 * b * width + 4 * b * d
    if prologue == "norm":
        nbytes += 4 * n + 4 * b
    peak = INT8_OPS_PER_S if exact else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * b * n * d / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_fused_kernels(torch):
    """The prologue-fused kernel for each (prologue, exact/fast) pair the
    main path runs (norm before wqkv, w13 and the classifier, none before
    wo, swiglu before w2) at qwen3-0.6b's matrices (layer 27's weights),
    b in FUSED_BATCHES, the norm's row factors rms_inv(x) given,
    against its plain version (the port's unfused chain in plain ops) and
    against the unfused kernel (the q8q8 or the fast tile kernel) on the
    plain prologue's output, bit for bit (the swiglu prologue's sigmoid
    is torch.sigmoid's formula and expf). Each row also equal to the same
    row of the b = 512 call, each call with its own rows' rms_inv (equal to
    the same rows' in the b = 512 call, or the phase fails). Times: the
    kernel, its plain
    version, as the library yardstick the unfused chain (the plain
    prologue ops, the quantization or bf16 rounding, and the unfused
    kernel), and the unfused kernel alone on the chain's activations; then
    their sums over a token's 113 launches at b = 1 and over a forward
    pass's 112 layer launches at each b."""
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.norms import rms_inv
    from qwen3_tpu_torch.ops.q8 import quantize_act

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = []
    for name, (n, d) in MATRICES.items():
        prologue = FUSED_PROLOGUES[name]
        w_q, w_s, _ = weight_stack(torch, name, gen)
        wl, sl = (w_q[L - 1], w_s[L - 1]) if name != "classifier" else (
            w_q, w_s)
        width = 2 * n if prologue == "swiglu" else n
        x_all = torch.randn(max(FUSED_BATCHES), width, device="cuda",
                            generator=gen)
        nw = 1 + 0.1 * torch.randn(n, device="cuda", generator=gen)
        for exact in (True, False):
            def kernel(x, inv):
                return qm.q8_matmul_fused(x, wl, sl, G, inv, nw,
                                          prologue=prologue, exact=exact)

            def plain(x, inv):
                return qm.q8_fused_matmul_plain(x, wl, sl, G, inv, nw,
                                                prologue=prologue,
                                                exact=exact)

            def unfused(x, inv):
                h = qm.fused_prologue(x, inv, nw, prologue)
                if exact:
                    return qm.q8_q8_matmul_tiled(*quantize_act(h, G), wl, sl,
                                                 G)
                return qm.q8_matmul_tiled_fast(h.to(torch.bfloat16), wl, sl,
                                               G)

            def row_inv(x):
                return rms_inv(x) if prologue == "norm" else None

            inv_all = row_inv(x_all)
            widest = kernel(x_all, inv_all)
            for b in FUSED_BATCHES:
                x = x_all[:b].contiguous()
                # each call's own row factors: the norm kernel's order is a
                # row's own, so they equal the same rows' in the widest call
                inv = row_inv(x)
                if inv is not None and not torch.equal(inv, inv_all[:b]):
                    fail(f"fused {name}: rms_inv of {b} rows differs from the "
                         f"same rows' in a {max(FUSED_BATCHES)}-row call")
                got = kernel(x, inv)
                label = f"fused {name} {prologue} exact={exact} b={b}"
                gaps = []
                for ref_name, ref in (("plain", plain(x, inv)),
                                      ("unfused", unfused(x, inv))):
                    torch.cuda.synchronize()
                    if not torch.isfinite(got).all():
                        fail(f"{label}: non-finite kernel output")
                    gaps.append((got - ref).abs().max().item())
                    if not torch.equal(got, ref):
                        fail(f"{label}: kernel != {ref_name} (max_abs_diff "
                             f"{gaps[-1]:.3e})")
                if not torch.equal(got, widest[:b]):
                    fail(f"{label}: rows differ from the same rows at "
                         f"b={max(FUSED_BATCHES)}")
                bnd, by = fused_bound_ms(b, n, d, prologue, exact)
                h = qm.fused_prologue(x, inv, nw, prologue)
                if exact:
                    xq, xs = quantize_act(h, G)

                    def alone(i, xq=xq, xs=xs):
                        return qm.q8_q8_matmul_tiled(xq, xs, wl, sl, G)
                else:
                    hb = h.to(torch.bfloat16)

                    def alone(i, hb=hb):
                        return qm.q8_matmul_tiled_fast(hb, wl, sl, G)
                row = dict(
                    matrix=name, prologue=prologue, exact=exact, b=b, n=n,
                    d=d, max_abs_diff=max(gaps),
                    kernel_ms=device_ms(torch, lambda i: kernel(x, inv)),
                    plain_ms=device_ms(torch, lambda i: plain(x, inv),
                                       reps=3),
                    library_ms=device_ms(torch, lambda i: unfused(x, inv)),
                    unfused_kernel_ms=device_ms(torch, alone),
                    bound_ms=bnd, bound_by=by)
                rows.append(row)
                log("fused " + json.dumps(row))
        del w_q, w_s
        torch.cuda.empty_cache()
    for exact in (True, False):
        for b in FUSED_BATCHES:
            mine = [r for r in rows if r["b"] == b and r["exact"] == exact]
            step = {k: sum(r[k] * (1 if r["matrix"] == "classifier"
                                   else L) for r in mine)
                    for k in ("kernel_ms", "library_ms", "unfused_kernel_ms",
                              "bound_ms")}
            layers = {k: L * sum(r[k] for r in mine
                                 if r["matrix"] != "classifier")
                      for k in ("kernel_ms", "library_ms",
                                "unfused_kernel_ms", "bound_ms")}
            log("fused step " + json.dumps(dict(
                exact=exact, b=b, launches=4 * L + 1, **step,
                layer_launches=4 * L,
                **{f"layers_{k}": v for k, v in layers.items()})))
    log("fused matmul: bit-equal to its plain version and to the unfused "
        "kernel on the plain prologue everywhere; library_ms = the unfused "
        "chain (plain prologue ops + quantize_act or the bf16 rounding + the "
        "q8q8 or fast kernel), unfused_kernel_ms = that kernel alone")
    return rows


NORM_BATCHES = (1, 8, 512)   # decode, serving's B = 8, a prefill block
# qwen3-0.6b's norms a layer: (label, heads, width) of the rows a token gives
# (the attention and ffn norms one row of dim, the QK-norms one row a head
# of the qkv output, as its views), and how many of each a token's forward
# pass ran before the folds (4 x 28 + 1 in all)
NORM_SHAPES = (("dim", 1, 1024), ("q_heads", 16, 128), ("k_heads", 8, 128))
NORM_PER_TOKEN = {"dim": 2 * L + 1, "q_heads": L, "k_heads": L}
# the folds: add_rmsnorm's rows (the QK-norm's head, the model dims of
# qwen3-0.6b, 4b and 8b) and qk_norm_rope's heads (qwen3's 128, heads of
# 128 threads past 1024); a token's launches of each entry at qwen3-0.6b
# (3 x 28 + 1), the rmsnorm rows of dim among them
FOLD_WIDTHS = (128, 1024, 2560, 4096)
FOLD_PER_TOKEN = {"rmsnorm": 2, "add_rmsnorm": 2 * L - 1, "qk_norm_rope": L}


def norm_bound_ms(rows, n):
    """The least time for rmsnorm: x read once, w read once and out written
    once (f32), over the memory rate."""
    return 1e3 * 4 * (2 * rows * n + n) / HBM_BYTES_PER_S


def phase_norm_kernel(torch):
    """The fixed-order norm kernel (the port's own: the JAX package's norms
    are XLA) at qwen3-0.6b's norms, b in NORM_BATCHES tokens: the rows of
    dim 1024, and the q and k heads of 128 as views of a qkv output. For
    each: rms_inv and rmsnorm one launch a call; rms_inv bit-equal to
    rms_inv_ordered (the kernel's order in plain ops) and within NORM_RTOL of
    the torch.mean chain; nw * (x * rms_inv(x)) equal to rmsnorm(x, nw) bit
    for bit; rmsnorm within 2 NORM_RTOL of the plain chain; every row at b =
    1 and 8 equal to the same row at b = 512 (a difference fails the run).
    Times: the kernel (rmsnorm), its plain chain, as the library yardstick
    torch.nn.functional.rms_norm, and the byte bound (log_norm_tokens sums
    them over a token beside the folds)."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.config import RMS_EPS
    from qwen3_tpu_torch.ops import norms
    from qwen3_tpu_torch.ops.cuda import norms as nm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows_out = []
    qkv_all = torch.randn(max(NORM_BATCHES), 1, 4096, device="cuda",
                          generator=gen) * 3
    x_all = torch.randn(max(NORM_BATCHES), 1, 1024, device="cuda",
                        generator=gen) * 3
    w_all = {n: 1 + 0.1 * torch.randn(n, device="cuda", generator=gen)
             for n in (128, 1024)}

    def view(label, b):
        if label == "dim":
            return x_all[:b]
        lo, heads = (0, 16) if label == "q_heads" else (2048, 8)
        return qkv_all[:b, :, lo:lo + heads * 128].reshape(b, 1, heads, 128)

    for label, heads, n in NORM_SHAPES:
        w = w_all[n]
        wide_inv = norms.rms_inv(view(label, max(NORM_BATCHES)))
        wide_out = norms.rmsnorm(view(label, max(NORM_BATCHES)), w)
        for b in NORM_BATCHES:
            x = view(label, b)
            tag = f"norm {label} b={b}"
            nm.reset_launches()
            inv = norms.rms_inv(x)
            out = norms.rmsnorm(x, w)
            torch.cuda.synchronize()
            if nm.LAUNCHES != dict(dict.fromkeys(nm.LAUNCHES, 0), rmsnorm=1,
                                   rms_inv=1):
                fail(f"{tag}: launches {nm.LAUNCHES}, want one a call")
            if not (torch.isfinite(inv).all() and torch.isfinite(out).all()):
                fail(f"{tag}: non-finite kernel output")
            if not torch.equal(inv, nm.rms_inv_ordered(x)):
                fail(f"{tag}: rms_inv != rms_inv_ordered")
            plain_inv = norms.rms_inv_plain(x)
            rel = ((inv - plain_inv).abs() / plain_inv).max().item()
            if rel > nm.NORM_RTOL:
                fail(f"{tag}: rms_inv vs the torch.mean chain {rel:.3e} past "
                     f"{nm.NORM_RTOL}")
            if not torch.equal(out, w * (x * inv)):
                fail(f"{tag}: rmsnorm != w * (x * rms_inv(x))")
            ref = norms.rmsnorm_plain(x, w)
            err = (out - ref).abs().max().item()
            if ((out - ref).abs() > 2 * nm.NORM_RTOL * ref.abs()).any():
                fail(f"{tag}: rmsnorm vs the plain chain {err:.3e} past "
                     f"2 * NORM_RTOL")
            if not (torch.equal(inv, wide_inv[:b])
                    and torch.equal(out, wide_out[:b])):
                fail(f"{tag}: rows differ from the same rows at "
                     f"b={max(NORM_BATCHES)}")
            n_rows = b * heads
            row = dict(
                norm=label, b=b, rows=n_rows, n=n, max_abs_diff=err,
                max_rel_inv=rel,
                kernel_ms=device_ms(torch, lambda i: norms.rmsnorm(x, w)),
                rms_inv_ms=device_ms(torch, lambda i: norms.rms_inv(x)),
                plain_ms=device_ms(torch, lambda i: norms.rmsnorm_plain(x, w)),
                library_ms=device_ms(torch, lambda i: F.rms_norm(
                    x, (n,), w, RMS_EPS)),
                bound_ms=norm_bound_ms(n_rows, n), bound_by="bytes")
            rows_out.append(row)
            log("norm " + json.dumps(row))
    log("norm kernel: bit-equal to rms_inv_ordered, a row's bits the same at "
        "b = 1, 8 and 512, rmsnorm = w * (x * rms_inv(x)) bit for bit; "
        "library_ms = torch.nn.functional.rms_norm")
    return rows_out


def fold_inputs(torch, gen, n, dtype):
    """x, y [512, 1, n] (x of very different row scales) and w [n]."""
    scale = torch.exp(8 * torch.rand(512, 1, 1, device="cuda",
                                     generator=gen) - 4)
    x = torch.randn(512, 1, n, device="cuda", generator=gen) * scale
    y = torch.randn(512, 1, n, device="cuda", generator=gen) * scale
    w = 1 + 0.1 * torch.randn(n, device="cuda", generator=gen)
    return x.to(dtype), y.to(dtype), w


def qk_inputs(torch, gen, d, b, layout, dtype):
    """q and k as views of a [b, 1, (H + 2 KV) d] qkv output (qwen3-0.6b's
    16 + 8 + 8 heads at d = 128, 2 + 1 + 1 past it), their norm weights,
    and the rope tables as the model gathers them: decode, b slots at
    positions 7 i ([b, 1, 1, half]); prefill, one block of b tokens from
    position 3 ([b, 1, half], q [1, b, H, d])."""
    from qwen3_tpu_torch.ops.rope import rope_tables

    H, KV = (16, 8) if d == 128 else (2, 1)
    qkv = (3 * torch.randn(b, 1, (H + 2 * KV) * d, device="cuda",
                           generator=gen)).to(dtype)
    if layout == "prefill":
        qkv = qkv.reshape(1, b, -1)
    B, T = qkv.shape[:2]
    q = qkv[..., :H * d].reshape(B, T, H, d)
    k = qkv[..., H * d:(H + KV) * d].reshape(B, T, KV, d)
    cos, sin = rope_tables(d, 4096, device="cuda")
    if layout == "prefill":
        pos = torch.arange(3, 3 + b, device="cuda")
        cos, sin = cos[pos][:, None, :], sin[pos][:, None, :]
    else:
        pos = 7 * torch.arange(b, device="cuda")
        cos, sin = cos[pos][:, None, None, :], sin[pos][:, None, None, :]
    ws = [1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
          for _ in range(2)]
    return q, k, ws[0], ws[1], cos, sin


def phase_norm_folds(torch):
    """The norm folds (ops/norms.py: add_rmsnorm, add_rms_inv, qk_norm_rope;
    csrc/rmsnorm.cu) at b in NORM_BATCHES, f32 and bf16: the add folds on
    rows of FOLD_WIDTHS, qk_norm_rope on heads of FOLD_WIDTHS as views of a
    qkv output and as contiguous heads, with the decode step's and the
    prefill's rope tables. Each one launch a call and bit-equal to its chain
    in plain ops on the card (x + y, then rmsnorm_ordered / rms_inv_ordered,
    the norm kernel's order; rmsnorm_ordered, then apply_rope's ops), a
    row's bits the same at every b; a difference fails the run. Times (f32; qk_norm_rope at qwen3's head of
    128): the fold, its chain of the port's kernels (chain_ms), its plain
    version (the torch.mean chain, plain_ms), as the library yardstick the
    chain on torch.nn.functional.rms_norm (torch.add + F.rms_norm; F.rms_norm
    twice + the rope ops) and the byte bound; then their sums over a decoded
    token's 3 x 28 + 1 launches (b = 1) beside the 4 x 28 + 1 norms, adds
    and ropes they replace."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.config import RMS_EPS
    from qwen3_tpu_torch.ops import norms
    from qwen3_tpu_torch.ops.cuda import norms as nm
    from qwen3_tpu_torch.ops.rope import apply_rope

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows_out = []

    def one_launch(tag, key, fn):
        nm.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if nm.LAUNCHES != dict(dict.fromkeys(nm.LAUNCHES, 0), **{key: 1}):
            fail(f"{tag}: launches {nm.LAUNCHES}, want one {key}")
        for t in out:
            if not torch.isfinite(t.float()).all():
                fail(f"{tag}: non-finite kernel output")
        return out

    def rms(x, w):
        return F.rms_norm(x, (x.shape[-1],), w, RMS_EPS)

    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for n in FOLD_WIDTHS:
            x_all, y_all, w = fold_inputs(torch, gen, n, dtype)
            wide = None
            for b in sorted(NORM_BATCHES, reverse=True):
                x, y = x_all[:b], y_all[:b]
                tag = f"fold add n={n} {dt} b={b}"
                s, h = one_launch(tag, "add_rmsnorm",
                                  lambda: norms.add_rmsnorm(x, y, w))
                s2, inv = one_launch(tag, "add_rms_inv",
                                     lambda: norms.add_rms_inv(x, y))
                chain = x + y
                if not (torch.equal(s, chain) and torch.equal(s2, chain)):
                    fail(f"{tag}: the sum != x + y")
                if not torch.equal(h, nm.rmsnorm_ordered(chain, w)):
                    fail(f"{tag}: add_rmsnorm != rmsnorm_ordered(x + y)")
                if not torch.equal(inv, nm.rms_inv_ordered(chain)):
                    fail(f"{tag}: add_rms_inv != rms_inv_ordered(x + y)")
                wide = wide or (h, inv)
                if not (torch.equal(h, wide[0][:b])
                        and torch.equal(inv, wide[1][:b])):
                    fail(f"{tag}: rows differ from the same rows at b=512")
                if dtype != torch.float32:
                    continue
                rows_out.append(dict(
                    fold="add_rmsnorm", n=n, b=b, max_abs_diff=0.0,
                    kernel_ms=device_ms(torch, lambda i: norms.add_rmsnorm(
                        x, y, w)),
                    add_rms_inv_ms=device_ms(
                        torch, lambda i: norms.add_rms_inv(x, y)),
                    add_rms_inv_chain_ms=device_ms(
                        torch, lambda i: norms.rms_inv(x + y)),
                    add_rms_inv_plain_ms=device_ms(
                        torch, lambda i: norms.add_rms_inv_plain(x, y)),
                    chain_ms=device_ms(torch, lambda i: norms.rmsnorm(
                        x + y, w)),
                    plain_ms=device_ms(torch, lambda i: norms.
                                       add_rmsnorm_plain(x, y, w)),
                    library_ms=device_ms(torch, lambda i: rms(x + y, w)),
                    bound_ms=1e3 * 4 * (4 * b * n + n) / HBM_BYTES_PER_S,
                    bound_by="bytes"))
                log("fold " + json.dumps(rows_out[-1]))
        for d in FOLD_WIDTHS:
            for layout in ("decode", "prefill"):
                q0, k0, wq, wk, cos0, sin0 = qk_inputs(
                    torch, gen, d, max(NORM_BATCHES), layout, dtype)
                wide = None
                for b in sorted(NORM_BATCHES, reverse=True):
                    tag = f"fold qk_norm_rope d={d} {dt} {layout} b={b}"
                    if layout == "decode":       # the first b slots
                        q, k = q0[:b], k0[:b]
                    else:                        # the first b tokens
                        q, k = q0[:, :b], k0[:, :b]
                    cos, sin = cos0[:b], sin0[:b]
                    for qq, kk in ((q, k), (q.contiguous(), k.contiguous())):
                        gq, gk = one_launch(
                            tag, "qk_norm_rope", lambda: norms.qk_norm_rope(
                                qq, kk, wq, wk, cos, sin))
                        if not (torch.equal(gq, apply_rope(
                                nm.rmsnorm_ordered(qq, wq), cos, sin))
                                and torch.equal(gk, apply_rope(
                                    nm.rmsnorm_ordered(kk, wk), cos, sin))):
                            fail(f"{tag}: != apply_rope(rmsnorm_ordered(.))"
                                 f", the chain in plain ops on the card")
                    wide = wide or (gq, gk)
                    rows_b = (slice(None, b),) if layout == "decode" else (
                        slice(None), slice(None, b))
                    if not (torch.equal(gq, wide[0][rows_b])
                            and torch.equal(gk, wide[1][rows_b])):
                        fail(f"{tag}: heads differ from the same heads at "
                             f"b={max(NORM_BATCHES)}")
                    if dtype != torch.float32 or d != 128:
                        continue
                    rows_out.append(dict(
                        fold="qk_norm_rope", n=d, b=b, layout=layout,
                        max_abs_diff=0.0,
                        kernel_ms=device_ms(torch, lambda i: norms.
                                            qk_norm_rope(q, k, wq, wk, cos,
                                                         sin)),
                        chain_ms=device_ms(torch, lambda i: (
                            apply_rope(norms.rmsnorm(q, wq), cos, sin),
                            apply_rope(norms.rmsnorm(k, wk), cos, sin))),
                        plain_ms=device_ms(torch, lambda i: norms.
                                           qk_norm_rope_plain(q, k, wq, wk,
                                                              cos, sin)),
                        library_ms=device_ms(torch, lambda i: (
                            apply_rope(rms(q, wq), cos, sin),
                            apply_rope(rms(k, wk), cos, sin))),
                        bound_ms=1e3 * 4 * (
                            2 * (q.numel() + k.numel()) + 2 * d
                            + cos.numel() + sin.numel()) / HBM_BYTES_PER_S,
                        bound_by="bytes"))
                    log("fold " + json.dumps(rows_out[-1]))
    log("norm folds: one launch a call, bit-equal to their chains in plain "
        "ops on the card, a row's bits the same at b = 1, 8 and 512; chain_ms = the "
        "port's kernels unfolded, library_ms = the chain on F.rms_norm")
    return rows_out


def norm_token(norm_rows, fold_rows, b=1):
    """A token's norm launches at qwen3-0.6b, b tokens a call (decode):
    {entry: {key: the sum over its launches}} for the folded pass's entries
    (FOLD_PER_TOKEN: rmsnorm on the rows of dim, add_rmsnorm at n = 1024,
    qk_norm_rope on the 16 + 8 heads of 128), and under "before" the 4 x 28
    + 1 rmsnorm launches of the unfolded pass (NORM_PER_TOKEN)."""
    dim = next(r for r in norm_rows if r["norm"] == "dim" and r["b"] == b)
    add = next(r for r in fold_rows if r["fold"] == "add_rmsnorm"
               and r["n"] == 1024 and r["b"] == b)
    qk = next(r for r in fold_rows if r["fold"] == "qk_norm_rope"
              and r["layout"] == "decode" and r["b"] == b)
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    out = {"rmsnorm": {k: FOLD_PER_TOKEN["rmsnorm"] * dim[k] for k in keys}}
    for name, r in (("add_rmsnorm", add), ("qk_norm_rope", qk)):
        out[name] = {k: FOLD_PER_TOKEN[name] * r[k]
                     for k in keys + ("chain_ms",)}
    out["rmsnorm"]["chain_ms"] = out["rmsnorm"]["kernel_ms"]
    out["before"] = {k: sum(r[k] * NORM_PER_TOKEN[r["norm"]]
                            for r in norm_rows if r["b"] == b)
                     for k in ("kernel_ms", "plain_ms", "library_ms")}
    return out


def log_norm_tokens(norm_rows, fold_rows):
    """The norm token lines: per b, the folded pass's 3 x 28 + 1 launches
    (kernel, the chain of unfolded kernels they replace with its adds and
    ropes, the plain versions, the F.rms_norm chain, the bound) beside the
    unfolded pass's 4 x 28 + 1 rmsnorm launches alone."""
    for b in NORM_BATCHES:
        t = norm_token(norm_rows, fold_rows, b)
        log("norm token " + json.dumps(dict(
            b=b, launches=3 * L + 1, before_launches=4 * L + 1,
            **{k: sum(t[e][k] for e in FOLD_PER_TOKEN)
               for k in ("kernel_ms", "chain_ms", "plain_ms", "library_ms",
                         "bound_ms")},
            before_rmsnorm_ms=t["before"]["kernel_ms"],
            by_entry={e: t[e]["kernel_ms"] for e in FOLD_PER_TOKEN})))


SAMPLER_VOCABS = (512, 151936)     # the tests' vocabulary and qwen3-0.6b's
SAMPLER_BATCHES = (1, 4, 8, 64)    # decode, a dp rank's share, B = 8, B = 64
SAMPLER_K = 64                     # the engines' top_k_hint


def sampler_bound_ms(rows, n, scan):
    """The least time for a sampler sum: the fp32 row read once and the sums
    written once (one a row, or n a row for the prefix sum), over the
    memory rate."""
    return 1e3 * 4 * (rows * n + (rows * n if scan else rows)) \
        / HBM_BYTES_PER_S


def phase_sampler_kernel(torch):
    """The sampler's fixed-order sums (the port's own kernels: the JAX
    package's sampler sums are XLA) at V in SAMPLER_VOCABS and B in
    SAMPLER_BATCHES, on softmax numerators and on their sorted
    probabilities, as sample_tokens gives them: softmax_sum and prefix_sum
    one launch a call, bit-equal to softmax_sum_ordered and cumsum_ordered
    (their order in plain ops), every row the same bits at every B, the
    prefix sum's first SAMPLER_K entries equal to the SAMPLER_K-value
    scan's; a difference fails the run. Times: the kernel, its plain
    version, as the library yardstick torch.sum / torch.cumsum, and the
    byte bound. Then sampler_batch_check (gated). Returns (rows, the batch
    check)."""
    from qwen3_tpu_torch.ops.cuda import sampler as cs

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rows_out = []
    for vocab in SAMPLER_VOCABS:
        x = 2.0 * torch.randn(max(SAMPLER_BATCHES), vocab, device="cuda",
                              generator=gen) / 0.8
        e = torch.exp(x - x.amax(-1, keepdim=True))
        sp = torch.sort(e / e.sum(-1, keepdim=True), dim=-1,
                        descending=True, stable=True)[0]
        wide = {"softmax_sum": cs.softmax_sum(e),
                "prefix_sum": cs.prefix_sum(sp)}
        k_scan = cs.prefix_sum(sp[:, :SAMPLER_K].contiguous())
        if not torch.equal(k_scan, wide["prefix_sum"][:, :SAMPLER_K]):
            fail(f"sampler V={vocab}: the first {SAMPLER_K} sums of the "
                 f"full scan differ from the {SAMPLER_K}-value scan's")
        for b in SAMPLER_BATCHES:
            for kind, data, kernel, plain, lib in (
                    ("softmax_sum", e[:b].contiguous(), cs.softmax_sum,
                     cs.softmax_sum_ordered,
                     lambda t: torch.sum(t, dim=-1)),
                    ("prefix_sum", sp[:b].contiguous(), cs.prefix_sum,
                     cs.cumsum_ordered, lambda t: torch.cumsum(t, dim=-1))):
                tag = f"sampler {kind} V={vocab} b={b}"
                cs.reset_launches()
                got = kernel(data)
                torch.cuda.synchronize()
                if cs.LAUNCHES[kind] != 1 or sum(cs.LAUNCHES.values()) != 1:
                    fail(f"{tag}: launches {cs.LAUNCHES}, want one")
                if not torch.isfinite(got).all():
                    fail(f"{tag}: non-finite kernel output")
                want = plain(data)
                if not torch.equal(got, want):
                    fail(f"{tag}: kernel != its ordered plain version "
                         f"({(got - want).abs().max().item():.3e})")
                if not torch.equal(got, wide[kind][:b]):
                    fail(f"{tag}: rows differ from the same rows at "
                         f"b={max(SAMPLER_BATCHES)}")
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    other = kernel(data)
                torch.cuda.current_stream().wait_stream(side)
                if not (torch.equal(kernel(data), got)
                        and torch.equal(other, got)):
                    fail(f"{tag}: a second call, or a call on a second "
                         f"stream, gives other bits")
                ref = lib(data)
                row = dict(
                    kernel=kind, vocab=vocab, b=b,
                    max_abs_diff=(got - want).abs().max().item(),
                    max_abs_diff_library=(got - ref).abs().max().item(),
                    kernel_ms=device_ms(torch, lambda i: kernel(data)),
                    plain_ms=device_ms(torch, lambda i: plain(data), reps=5),
                    library_ms=device_ms(torch, lambda i: lib(data)),
                    bound_ms=sampler_bound_ms(b, vocab,
                                              kind == "prefix_sum"),
                    bound_by="bytes")
                rows_out.append(row)
                log("sampler kernel " + json.dumps(row))
    log("sampler kernels: bit-equal to their ordered plain versions, a "
        "row's bits the same at b = 1, 4, 8 and 64, back to back and on a "
        "second stream, the top-64 scan the full scan's prefix; library_ms "
        "= torch.sum / torch.cumsum")
    return rows_out, sampler_batch_check(torch)


KV_CACHE = (28, 64, 512, 8, 128)   # qwen3-0.6b's cache at serve --batch 64 -c 512


def kernel_events(torch, fn, name="kernels"):
    """The kernels fn() launches on the card, by name, from torch.profiler's
    Chrome trace (its "kernel" events; copies are not kernels). The host
    sleeps a little on both sides of fn inside the window: the profiler
    drops device events it places outside its window, which a window of one
    short kernel can miss. Fails when the trace holds no kernel at all:
    then the count is not shown."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    trace = HERE / "build" / f"{name}.trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    if not names:
        fail(f"{name}: the profiler's trace holds no kernel event")
    return names


def phase_kv_write(torch):
    """kv_write_rows (the JAX package's in-place per-slot row write, which
    no path runs) at qwen3-0.6b's B = 64 serving cache [28, 64, 512, 8,
    128], f32 and bf16, layers 0 and 27, int64 positions (as torch.randint
    makes them) and the same as int32, with both edges and a duplicate:
    bit-equal to its plain version, every row it did not write unchanged,
    and one kernel a call by torch.profiler's kernel events (the wrapper
    makes no device op of its own). Times, with int64 positions (int32
    beside): the kernel, its plain version, and as the library yardstick
    the same indexed assignment as one index_put_. The bound: the f32 rows
    read once and written once in the cache's type, over the memory
    rate."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    n_layers, B, S, KV, D = KV_CACHE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows_in = torch.randn(B, KV, D, device="cuda", generator=gen)
    pos = torch.randint(0, S, (B,), device="cuda", generator=gen)
    pos[:4] = torch.tensor([0, S - 1, 7, 7], device="cuda")
    positions = {"int64": pos, "int32": pos.to(torch.int32)}
    slots = torch.arange(B, device="cuda")
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        cache = torch.randn(KV_CACHE, device="cuda", generator=gen).to(dtype)
        for pname, p in positions.items():
            for layer in (0, n_layers - 1):
                label = f"kv_write {dtype} {pname} layer={layer}"
                got = cache.clone()
                names = kernel_events(torch, lambda: kw.kv_write_rows(
                    got, rows_in, layer, p), "kv_write")
                if len(names) != 1:
                    fail(f"{label}: {len(names)} kernels a call ({names}), "
                         f"want 1")
                want = kw.kv_write_rows_plain(cache.clone(), rows_in, layer,
                                              p)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"{label}: kernel != plain")
                got[layer, slots, pos] = cache[layer, slots, pos]
                if not torch.equal(got, cache):
                    fail(f"{label}: a row it did not write changed")
                del got, want
        cast = rows_in.to(dtype)

        def library(i):
            cache[i % n_layers].index_put_((slots, pos), cast)

        def kernel(p):
            return lambda i: kw.kv_write_rows(cache, rows_in, i % n_layers, p)

        es = cache.element_size()
        row = dict(kernel="kv_write_rows", dtype=str(dtype).split(".")[-1],
                   cache=list(KV_CACHE), max_abs_diff=0.0,
                   kernels_a_call=1,
                   kernel_ms=device_ms(torch, kernel(positions["int64"])),
                   kernel_ms_int32=device_ms(torch,
                                             kernel(positions["int32"])),
                   plain_ms=device_ms(torch, lambda i: kw.kv_write_rows_plain(
                       cache, rows_in, i % n_layers, pos)),
                   library_ms=device_ms(torch, library),
                   bound_ms=1e3 * (B * KV * D * (4 + es) + 8 * B)
                   / HBM_BYTES_PER_S, bound_by="bytes")
        out.append(row)
        log("kv_write " + json.dumps(row))
        del cache
        torch.cuda.empty_cache()
    return out


UNTILED_BATCHES = (1, 8, 512)   # b <= 8 runs the dequant kernel's GEMV
# q8_matmul_pallas's (compute dtype, postscale) pairs
UNTILED_MODES = (("float32", False), ("float32", True), ("bfloat16", False),
                 ("bfloat16", True))
# q8_q8_matmul_pallas: the GEMV against the MMA tile path at these b (the
# crossover: the GEMV is built up to UNTILED_Q8Q8_GEMV_ROWS)
QG_CROSS_BATCHES = (1, 2, 4)
# both routes at b = 1 on each side of the planner's column threshold
# (plan_untiled_q8q8: the GEMV below UNTILED_Q8Q8_TILE_BLOCKS tile blocks,
# 16896 columns): qwen3-4b's four layer matrices in [n, d]
QG_RULE_SHAPES = {"qwen3-4b wqkv": (2560, 6144), "qwen3-4b wo": (4096, 2560),
                  "qwen3-4b w13": (2560, 19456), "qwen3-4b w2": (9728, 2560)}


def untiled_bound_ms(b, n, d, compute):
    """The least time for q8_matmul_pallas: the int8 weights and their f32
    scales, the f32 activations read once and the f32 output written once,
    over the memory rate; or its operations over the peak of the compute
    type (fp32 outside the tensor cores, or bf16)."""
    nbytes = d * n + 4 * d * (n // G) + 4 * b * n + 4 * b * d
    peak = FP32_OPS_PER_S if compute == "float32" else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * b * n * d / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def per_pass(rows, b, keys, classifier=True):
    """A forward pass's sums of `keys` over `rows` at b rows: the four layer
    matrices x 28 layers and, with `classifier`, the classifier once."""
    mine = [r for r in rows if r["b"] == b
            and (classifier or r["matrix"] != "classifier")]
    return {k: sum(r[k] * (1 if r["matrix"] == "classifier" else L)
                   for r in mine) for k in keys}


def phase_untiled_kernels(torch):
    """The untiled matmuls on contraction-leading weights (which only the
    JAX package's tests call) at qwen3-0.6b's five matrices in [n, d]
    layout, b in UNTILED_BATCHES: q8_q8_matmul_pallas bit for bit against
    its plain version, each row equal to the same row at b = 512, and the
    b = 512 call equal to q8_q8_matmul_tiled (row 1's kernel) on the
    transposed weights; q8_matmul_pallas in f32 and bf16, pre- and
    post-scaled, within 1e-5 * max|plain| (the kernel sums each dot as an
    fmaf chain in k order, the plain version's torch.matmul in its own
    order; bf16 products are exact in fp32), and each row of the GEMV's
    calls (b = 1, 8) equal bit for bit to the same row in the tile
    kernel's b = 512 call. Times: the kernel, its plain version and as the
    library yardstick F.linear on bf16 with the weights dequantized once to
    bf16 (bound_ms for q8q8 as phase_kernels'), and for the f32 variants
    also F.linear in f32 with TF32 off (cuBLAS SGEMM, the same function in
    the same precision); bound_ms at the peak of the compute type, and for
    the bf16 variants also fma_floor_ms, their FMAs over the fp32 peak
    outside the tensor cores (the floor of the k-order fmaf chains the
    kernel runs); then each variant's sum over a token's 113
    matrices at b = 1 and 8 and over a 512-row block's 112 layer matrices.
    The dequant kernel's tile routes at b = 512, forced (every tile shape,
    every split that divides the k-tiles), each equal to the planned
    call's rows, with their times. For q8_q8_matmul_pallas also, each
    route bit-equal to the b = 512 rows: the GEMV against the MMA tile path at
    QG_CROSS_BATCHES (the crossover the planner's UNTILED_Q8Q8_GEMV_ROWS
    should follow), and both routes at b = 1 on QG_RULE_SHAPES (the
    planner's column threshold)."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.q8 import quantize_act
    from qwen3_tpu_torch.tools.untiled_routes import tile_routes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows, routes, tiles = [], [], []
    for name, (n, d) in MATRICES.items():
        w_q = torch.randint(-127, 128, (n, d), dtype=torch.int8,
                            device="cuda", generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(n // G, d, device="cuda",
                                             generator=gen))
        w_f32 = (w_q.float().reshape(n // G, G, d)
                 * w_s[:, None, :]).reshape(n, d).T.contiguous()
        w_bf = w_f32.to(torch.bfloat16)
        x_all = torch.randn(max(UNTILED_BATCHES), n, device="cuda",
                            generator=gen)
        widest = {}
        for compute, post in UNTILED_MODES:
            widest[compute, post] = qm.q8_matmul_pallas(
                x_all, w_q, w_s, G, compute_dtype=getattr(torch, compute),
                postscale=post)
        xq_all, xs_all = quantize_act(x_all, G)
        wide_q8q8 = qm.q8_q8_matmul_pallas(xq_all, xs_all, w_q, w_s, G)
        row1 = qm.q8_q8_matmul_tiled(xq_all, xs_all, w_q.T.contiguous(),
                                     w_s.T.contiguous(), G)
        torch.cuda.synchronize()
        if not torch.equal(wide_q8q8, row1):
            fail(f"untiled q8q8 {name} b={max(UNTILED_BATCHES)}: != "
                 f"q8_q8_matmul_tiled on the transposed weights")
        del row1
        for b in UNTILED_BATCHES:
            x = x_all[:b].contiguous()
            xq, xs = quantize_act(x, G)
            x_bf = x.to(torch.bfloat16)

            def library(i, x_bf=x_bf):
                return F.linear(x_bf, w_bf)

            def library_f32(i, x=x):
                return F.linear(x, w_f32)     # cuBLAS SGEMM: TF32 is off

            l_ms = device_ms(torch, library)
            lf_ms = device_ms(torch, library_f32)
            got = qm.q8_q8_matmul_pallas(xq, xs, w_q, w_s, G)
            want = qm.q8_q8_matmul_pallas_plain(xq, xs, w_q, w_s, G)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or not torch.equal(got, want):
                fail(f"untiled q8q8 {name} b={b}: kernel != plain "
                     f"(max_abs_diff {err:.3e})")
            if not torch.equal(got, wide_q8q8[:b]):
                fail(f"untiled q8q8 {name} b={b}: rows differ from the same "
                     f"rows at b={max(UNTILED_BATCHES)}")
            bnd, by = bound_ms(b, n, d)
            variants = [("q8q8_pallas", bnd, by, err,
                         lambda i, xq=xq, xs=xs: qm.q8_q8_matmul_pallas(
                             xq, xs, w_q, w_s, G),
                         lambda i, xq=xq, xs=xs: qm.q8_q8_matmul_pallas_plain(
                             xq, xs, w_q, w_s, G))]
            for compute, post in UNTILED_MODES:
                cdt = getattr(torch, compute)

                def kernel(i, x=x, cdt=cdt, post=post):
                    return qm.q8_matmul_pallas(x, w_q, w_s, G,
                                               compute_dtype=cdt,
                                               postscale=post)

                def plain(i, x=x, cdt=cdt, post=post):
                    return qm.q8_matmul_pallas_plain(x, w_q, w_s, G,
                                                     compute_dtype=cdt,
                                                     postscale=post)

                got, want = kernel(0), plain(0)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                label = f"untiled {name} {compute} postscale={post} b={b}"
                if not torch.isfinite(got).all():
                    fail(f"{label}: non-finite kernel output")
                if err > 1e-5 * want.abs().max().item():
                    fail(f"{label}: kernel vs plain {err:.3e} past 1e-5 * "
                         f"max|plain|")
                if not torch.equal(got, widest[compute, post][:b]):
                    fail(f"{label}: rows differ from the same rows at "
                         f"b={max(UNTILED_BATCHES)}")
                bnd, by = untiled_bound_ms(b, n, d, compute)
                variants.append((f"pallas_{compute}_"
                                 f"{'post' if post else 'pre'}", bnd, by, err,
                                 kernel, plain))
            for kind, bnd, by, err, kernel, plain in variants:
                row = dict(matrix=name, kernel=kind, b=b, n=n, d=d,
                           max_abs_diff=err,
                           kernel_ms=device_ms(torch, kernel),
                           plain_ms=device_ms(torch, plain, reps=3),
                           library_ms=l_ms, bound_ms=bnd, bound_by=by)
                if kind.startswith("pallas_float32"):
                    row["library_f32_ms"] = lf_ms
                elif kind.startswith("pallas_bfloat16"):
                    # the floor under the k-order rule: these fmaf chains
                    # run on CUDA cores, which the bf16 bound does not ask
                    row["fma_floor_ms"] = untiled_bound_ms(b, n, d,
                                                           "float32")[0]
                rows.append(row)
                log("untiled " + json.dumps(row))
        # q8_matmul_pallas's tile kernel at b = 512 on every route, forced:
        # every tile shape, each split that divides the k-tiles; each equal
        # to the planned call's rows
        b = max(UNTILED_BATCHES)
        planned = qm.plan_untiled(b, n, d, G)
        for compute, post in UNTILED_MODES:
            cdt = getattr(torch, compute)
            for shape, sp in tile_routes(n, G):
                def call(i, shape=shape, sp=sp, cdt=cdt, post=post):
                    return qm.q8_untiled_launch(x_all, w_q, w_s, G, 512, cdt,
                                                post, False, shape, sp)

                got = call(0)
                torch.cuda.synchronize()
                if not torch.equal(got, widest[compute, post]):
                    fail(f"untiled {name} {compute} postscale={post} b={b} "
                         f"route ({shape}, {sp}): rows differ from the "
                         f"planned route's")
                tiles.append(dict(
                    matrix=name, kernel=f"pallas_{compute}_"
                    f"{'post' if post else 'pre'}", b=b, n=n, d=d,
                    tile=qm.UNTILED_TILE_SHAPES[shape], k_splits=sp,
                    planned=planned == (False, shape, sp),
                    kernel_ms=device_ms(torch, call)))
                log("untiled tile route " + json.dumps(tiles[-1]))
        # q8_q8_matmul_pallas's routes, forced, each against the b = 512
        # rows
        for b in QG_CROSS_BATCHES:
            xq, xs = xq_all[:b].contiguous(), xs_all[:b].contiguous()
            shape, splits = qm.plan_q8q8(b, n, d, G)
            pair = (("gemv_ms", (True, 0, 1)),
                    ("tile_ms", (False, shape, splits)))
            row = dict(matrix=name, b=b, n=n, d=d, tile_rows=qm.TILE_ROWS[
                shape], k_splits=splits,
                planned="gemv" if qm.plan_untiled_q8q8(b, n, d, G)[0]
                else "tile")
            for key, route in pair:
                def call(i, xq=xq, xs=xs, route=route):
                    return qm.q8_q8_untiled_launch(xq, xs, w_q, w_s, G, 512,
                                                   *route)

                got = call(0)
                torch.cuda.synchronize()
                if not torch.equal(got, wide_q8q8[:b]):
                    fail(f"untiled q8q8 {name} b={b} route {route}: rows "
                         f"differ from the same rows at "
                         f"b={max(UNTILED_BATCHES)}")
                row[key] = device_ms(torch, call)
            routes.append(row)
            log("untiled q8q8 route " + json.dumps(row))
        del w_q, w_s, w_bf, w_f32
        torch.cuda.empty_cache()
    for name, (n, d) in QG_RULE_SHAPES.items():
        w_q = torch.randint(-127, 128, (n, d), dtype=torch.int8,
                            device="cuda", generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(n // G, d, device="cuda",
                                             generator=gen))
        xq, xs = quantize_act(torch.randn(1, n, device="cuda", generator=gen),
                              G)
        want = qm.q8_q8_matmul_pallas_plain(xq, xs, w_q, w_s, G)
        row = dict(matrix=name, b=1, n=n, d=d, planned="gemv" if
                   qm.plan_untiled_q8q8(1, n, d, G)[0] else "tile")
        for key, route in (("gemv_ms", (True, 0, 1)),
                           ("tile_ms", (False, *qm.plan_q8q8(1, n, d, G)))):
            def call(i, route=route):
                return qm.q8_q8_untiled_launch(xq, xs, w_q, w_s, G, 512,
                                               *route)

            got = call(0)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"untiled q8q8 {name} b=1 route {route}: kernel != "
                     f"plain")
            row[key] = device_ms(torch, call)
        log("untiled q8q8 rule " + json.dumps(row))
        del w_q, w_s
    for b in UNTILED_BATCHES[:2]:
        for kind in sorted({r["kernel"] for r in rows}):
            mine = [r for r in rows if r["kernel"] == kind]
            log("untiled token " + json.dumps(dict(
                kernel=kind, b=b, launches=4 * L + 1, **per_pass(
                    mine, b, ("kernel_ms", "library_ms", "bound_ms")))))
    for kind in sorted({r["kernel"] for r in rows}):
        mine = [r for r in rows if r["kernel"] == kind]
        keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms") + tuple(
            k for k in ("library_f32_ms", "fma_floor_ms") if k in mine[0])
        log("untiled block " + json.dumps(dict(
            kernel=kind, b=max(UNTILED_BATCHES), layer_matmuls=4 * L,
            **per_pass(mine, max(UNTILED_BATCHES), keys, classifier=False))))
    for kind in sorted({r["kernel"] for r in tiles}):
        for tile in qm.UNTILED_TILE_SHAPES:
            # a 512-row block's layer matrices with each matrix on its
            # fastest split at this tile shape, and on the planned route
            best = [min((r for r in tiles if r["kernel"] == kind
                         and r["matrix"] == m and r["tile"] == tile),
                        key=lambda r: r["kernel_ms"])
                    for m in MATRICES if m != "classifier"]
            log("untiled tile block " + json.dumps(dict(
                kernel=kind, tile=tile, fastest_ms=L * sum(
                    r["kernel_ms"] for r in best),
                splits={r["matrix"]: r["k_splits"] for r in best})))
        planned = [r for r in tiles if r["kernel"] == kind and r["planned"]
                   and r["matrix"] != "classifier"]
        log("untiled tile block " + json.dumps(dict(
            kernel=kind, planned_ms=L * sum(r["kernel_ms"] for r in planned))))
    for b in QG_CROSS_BATCHES:
        log("untiled q8q8 routes " + json.dumps(dict(
            b=b, **per_pass(routes, b, ("gemv_ms", "tile_ms"))))
            + " (a token's 113 matrices)")
    log("untiled matmuls: q8q8 bit-equal to its plain version and to row 1 "
        "on w_q.T, on every route, the dequant kernel within 1e-5 * "
        "max|plain| and its rows equal at every b and on every route; "
        "library_ms = torch.nn.functional.linear on bf16 with the weights "
        "dequantized once to bf16, library_f32_ms (f32 variants) the same "
        "in f32 with TF32 off")
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


def launch_modules():
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd
    from qwen3_tpu_torch.ops.cuda import kv_write as kw
    from qwen3_tpu_torch.ops.cuda import norms as nm
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.cuda import sampler as sm
    from qwen3_tpu_torch.tools import probe_dma as pd

    return qm, fd, bd, kw, pd, nm, sm


def norm_launches(passes, fused, layers=L):
    """The norm kernel's launches, by entry, of `passes` forward passes of
    which `fused` run the fused matmuls: a pass 2 plain norms (layer 0's
    attention norm, the output norm), 2 L - 1 residual adds with their norm
    (every ffn norm and every later layer's attention norm) and L QK-norm
    ropes; rms_inv and add_rms_inv where fused, rmsnorm and add_rmsnorm
    elsewhere."""
    L, unfused = layers, passes - fused
    return {"rmsnorm": 2 * unfused, "add_rmsnorm": (2 * L - 1) * unfused,
            "rms_inv": 2 * fused, "add_rms_inv": (2 * L - 1) * fused,
            "qk_norm_rope": L * passes}


def want_launches(calls, layers=L):
    """What the forward passes counted in `calls` (models.qwen3.CALLS
    deltas) must launch: every pass 4 x 28 layer matmuls and 1 classifier
    matmul of its route's kernels (mode pallas the q8q8 kernels,
    pallas-fast the fast ones, pallas-int8 the int8 ones, with fuse the
    fused kernel for all 113; modes exact and bf16 no kernel); every pass
    that resolved to a kernel attention 28 launches of it (prefill blocks
    flash prefill; decode steps, the fused chunk's forward_step passes
    included, flash decode, or over the serving side buffer the
    two-segment flash or the batched decode kernel); no other
    pass launches an attention kernel; every pass in every mode 3 x 28 + 1
    norm kernel launches (norm_launches): unfused, rmsnorm before layer 0's
    wqkv (or q, k and v) and before the classifier, add_rmsnorm (the
    residual add with the norm after it) before w13 (or w1 and w3) and
    every later layer's wqkv, qk_norm_rope (the QK-norms and the rope) a
    layer; fused, the same with rms_inv and add_rms_inv for the norm
    prologues' row factors; no pass launches the kernels that only the tests and the probe call
    (the KV row write, the untiled matmuls, the pure reads); every
    sample_tokens call that sampled (runtime/sampler.py's CALLS, in
    `calls` as "sampled") one launch of each sampler kernel. `layers`: the
    model's (qwen3-0.6b's 28 by default)."""
    L = layers
    mm = {route: calls["mm_" + route] for route in (
        "pallas", "pallas-fast", "pallas-int8", "fused")}
    passes = (calls["forward"] + calls["decode_forward"]
              + calls["forward_step"])
    return {**norm_launches(passes, mm["fused"], L),
            "stacked": 4 * L * mm["pallas"], "tiled": mm["pallas"],
            "stacked_fast": 4 * L * mm["pallas-fast"],
            "tiled_fast": mm["pallas-fast"],
            "stacked_int8": 4 * L * mm["pallas-int8"],
            "tiled_int8": mm["pallas-int8"],
            "fused": (4 * L + 1) * mm["fused"],
            "flash_decode": L * (calls["decode_forward_flash"]
                                 + calls["forward_step_flash"]),
            "flash_prefill": L * calls["forward_flash"],
            "flash_decode_two_segment":
                L * calls["decode_forward_two_segment"],
            "batched_decode_partial": L * calls["decode_forward_fused"],
            "kv_write": 0, "q8q8_pallas": 0, "pallas": 0,
            "pure_read_stacked": 0, "pure_read_manual": 0,
            "softmax_sum": calls["sampled"], "prefix_sum": calls["sampled"]}


def all_calls():
    """The forward passes (models.qwen3.CALLS) and the sampler's calls
    (runtime/sampler.py's CALLS) counted so far, one dict."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime import sampler

    return {**model.CALLS, **sampler.CALLS}


def checked(torch, label, fn, layers=L):
    """Run fn() with the launch-count check (want_launches for a model of
    `layers` layers); returns (fn's result, {blocks, steps, launches,
    calls, wall})."""
    before, calls0 = read_counts(), all_calls()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c - before[k] for k, c in read_counts().items()}
    calls = {k: c - calls0[k] for k, c in all_calls().items()}
    blocks = calls["forward"]
    steps = calls["decode_forward"] + calls["forward_step"]
    if steps == 0 or blocks == 0:
        fail(f"{label}: no prefill block or no decode step ran")
    want = want_launches(calls, layers)
    # the fast matmul's route counts: one a stacked_fast or tiled_fast call
    from qwen3_tpu_torch.ops.cuda.q8_matmul import ROUTE_KEYS

    routes = sum(launches.pop(k) for k in ROUTE_KEYS)
    if launches != want or routes != want["stacked_fast"] + want["tiled_fast"]:
        fail(f"{label}: launches {launches} and {routes} fast routes for "
             f"passes {calls}; want {want}")
    return result, dict(blocks=blocks, steps=steps, launches=launches,
                        calls=calls, wall=wall)


def checked_run(torch, label, argv, stdin_text=""):
    """One CLI run with the launch-count check (want_launches)."""
    (out, err), run = checked(torch, label,
                              lambda: run_cli(argv, stdin_text))
    calls = run["calls"]
    metrics = re.findall(r"\[(pp|tg|t/ms|tok/s) ([0-9.]+)(?:ms)?\]", err)
    log(f"{label}: {len(out)} stdout bytes, {run['blocks']} prefill blocks "
        f"({calls['forward_flash']} flash), {run['steps']} decode steps "
        f"({calls['decode_forward_flash']} flash), launches "
        f"{ {k: n for k, n in run['launches'].items() if n} }, wall "
        f"{run['wall']:.2f} s, cli {metrics}")
    run["metrics"] = metrics
    return out, err, run


def reset_counts():
    for mod in launch_modules():
        mod.reset_launches()


def read_counts():
    out = {}
    for mod in launch_modules():
        out.update(mod.LAUNCHES)
    return out


def phase_end_to_end(torch, path: str):
    """The first slice's path (depth < 8192: completion at -c 4096, seeded
    twice, chat), then the long-context path (see phase_long_context), each
    with the launch counts set to 0 just before it and read just after.
    Returns ({path: counts}, runs)."""
    from qwen3_tpu_torch.runtime.decode_loop import prefill_plan
    from qwen3_tpu_torch.tokenizer import Tokenizer

    base = [path, "--device", "cuda"]     # CLI defaults otherwise
    n_prompt = len(Tokenizer.from_file(path).encode(PROMPT))
    plan = prefill_plan(n_prompt, 0, 64, 4096)
    log(f"prompt: {len(PROMPT.encode())} bytes, {n_prompt} tokens, prefill "
        f"plan {[w for _, w in plan]}")
    if max(w for _, w in plan) != 512:
        fail("the prompt does not reach a 512-row prefill block")

    reset_counts()
    runs = {}
    out, err, runs["greedy"] = checked_run(
        torch, "greedy", base + ["-m", "completion", "-i", PROMPT, "-t", "0",
                                 "-s", "42", "-c", "4096",
                                 "--max-tokens", str(E2E_TOKENS)])
    if runs["greedy"]["blocks"] != len(plan):
        fail(f"greedy: {runs['greedy']['blocks']} prefill blocks, plan has "
             f"{len(plan)}")
    if not out.startswith(PROMPT.encode()):
        fail("greedy: stdout does not start with the prompt")
    seeded = base + ["-m", "completion", "-i", PROMPT, "-t", "0.8", "-p",
                     "0.9", "-s", "7", "-c", "4096", "--max-tokens",
                     str(E2E_TOKENS)]
    out1, _, runs["seeded_1"] = checked_run(torch, "seeded run 1", seeded)
    out2, _, runs["seeded_2"] = checked_run(torch, "seeded run 2", seeded)
    if out1 != out2:
        fail("seeded: the two runs printed different bytes")
    out, err, runs["chat"] = checked_run(
        torch, "chat", base + ["-m", "chat", "-t", "0.8", "-s", "11", "-c",
                               "192", "-y", "You are brief."],
        stdin_text="Tell me about the clockmaker.\nAnd the children?\n\n")
    if err.count("[t/ms") != 2:
        fail("chat: expected two turns with metrics")
    counts = {"short": read_counts()}
    log(f"main path launches below depth 8192 (the runs above): "
        f"{counts['short']}")
    if min(counts["short"][k] for k in ("stacked", "tiled", "rmsnorm",
                                        "add_rmsnorm", "qk_norm_rope",
                                        "softmax_sum", "prefix_sum")) == 0:
        fail("a kernel of the path was never launched")

    reset_counts()
    runs.update(phase_long_context(torch, path))
    counts["long"] = read_counts()
    log(f"main path launches at long context (the runs above): "
        f"{counts['long']}")
    if min(counts["long"][k] for k in ("stacked", "tiled", "flash_decode",
                                       "flash_prefill", "rmsnorm",
                                       "add_rmsnorm", "qk_norm_rope",
                                       "softmax_sum", "prefix_sum")) == 0:
        fail("a kernel of the long-context path was never launched")
    return counts, runs


LONG_PROMPT = (
    "Once upon a time there was a small town at the edge of a forest, and "
    "in the town there lived an old clockmaker and the children who came to "
    "watch him work. "
) * 71


def phase_long_context(torch, path: str):
    """The long-context path through the CLI: a completion with every CLI
    default (no -c: the context is 32768; int8 KV; --attn auto) on an
    8378-token prompt, so its prefill blocks cross depth 8192 and every
    decode step runs flash decode; the same seeded twice, with equal stdout;
    and --attn flash at -c 4096 on the short prompt, where prefill and
    decode run flash from position 0. Each run's flash launches must be 28
    per flash-resolved pass (checked_run), and the passes must resolve as
    the JAX engine's rule says: a prefill block by its start, a decode
    chunk by its first step's depth."""
    from qwen3_tpu_torch.runtime.decode_loop import prefill_plan
    from qwen3_tpu_torch.tokenizer import Tokenizer

    base = [path, "--device", "cuda"]
    n_long = len(Tokenizer.from_file(path).encode(LONG_PROMPT))
    plan = prefill_plan(n_long, 0, 64, 32768)
    flash_blocks = sum(off >= FLASH_DEPTH for off, _ in plan)
    log(f"long prompt: {n_long} tokens, prefill plan "
        f"{[w for _, w in plan]}, {flash_blocks} blocks start at or past "
        f"{FLASH_DEPTH}")
    if not n_long > FLASH_DEPTH or flash_blocks == 0:
        fail("the long prompt does not cross depth 8192")
    runs = {}
    greedy = base + ["-m", "completion", "-i", LONG_PROMPT, "-t", "0", "-s",
                     "42", "--max-tokens", "32"]
    out, _, runs["long_greedy"] = checked_run(torch, "long greedy", greedy)
    seeded = base + ["-m", "completion", "-i", LONG_PROMPT, "-t", "0.8",
                     "-p", "0.9", "-s", "7", "--max-tokens", "32"]
    out1, _, runs["long_seeded_1"] = checked_run(torch, "long seeded run 1",
                                                 seeded)
    out2, _, runs["long_seeded_2"] = checked_run(torch, "long seeded run 2",
                                                 seeded)
    if out1 != out2:
        fail("long seeded: the two runs printed different bytes")
    for name in ("long_greedy", "long_seeded_1", "long_seeded_2"):
        c = runs[name]["calls"]
        if (c["forward"] != len(plan) or c["forward_flash"] != flash_blocks
                or c["decode_forward_flash"] != c["decode_forward"]):
            fail(f"{name}: passes {c}; want {len(plan)} prefill blocks, "
                 f"{flash_blocks} of them flash, and every decode step flash")
    if not out.startswith(LONG_PROMPT.encode()):
        fail("long greedy: stdout does not start with the prompt")
    _, _, runs["flash_4096"] = checked_run(
        torch, "--attn flash -c 4096", base + [
            "-m", "completion", "-i", PROMPT, "-t", "0.8", "-s", "5", "-c",
            "4096", "--attn", "flash", "--max-tokens", "32"])
    c = runs["flash_4096"]["calls"]
    if (c["forward_flash"] != c["forward"]
            or c["decode_forward_flash"] != c["decode_forward"]):
        fail(f"--attn flash: passes {c}; want every pass flash")
    return runs


def serve_prompts(n, lo, hi, seed):
    """n prompts of lo..hi words of PROMPT's text, one per line."""
    import random

    words = PROMPT.split()
    rnd = random.Random(seed)
    out = []
    for _ in range(n):
        k = rnd.randint(lo, hi)
        i = rnd.randrange(len(words) - k)
        out.append(" ".join(words[i:i + k]))
    return out


def run_serve(argv, prompts, workdir: Path):
    """qwen3_tpu_torch.serve.main in this process on `prompts` (written to
    a file); returns (JSON records in stdout order, stderr text)."""
    from qwen3_tpu_torch import serve

    pfile = workdir / "prompts.txt"
    pfile.write_text("\n".join(prompts) + "\n", encoding="utf-8")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = serve.main(argv + ["--prompts", str(pfile)])
    if rc != 0:
        fail(f"serve {argv} returned {rc}:\n{err.getvalue()}")
    return [json.loads(ln) for ln in out.getvalue().splitlines()], \
        err.getvalue()


def checked_serve(torch, label, argv, prompts, workdir, attn, max_tokens,
                  mode="pallas-fast", fuse=False):
    """One serve.py run with the launch-count check; every request must
    come back once with at most `max_tokens` tokens (none when its first
    sample is a stop token), some tokens in all, every prefill block and
    decode step must run `mode` (its matmuls fused when `fuse`) and every
    decode step `attn`."""
    (recs, err), run = checked(
        torch, label, lambda: run_serve(argv, prompts, workdir))
    calls = run["calls"]
    kind = {"fused": "decode_forward_fused",
            "flash": "decode_forward_two_segment"}[attn]
    fast = mode == "pallas-fast"
    if (calls[kind] != run["steps"]
            or calls["forward_fast"] != fast * run["blocks"]
            or calls["decode_forward_fast"] != fast * run["steps"]):
        fail(f"{label}: passes {calls}; want every block {mode} and every "
             f"step {attn}")
    check_route(label, run, "fused" if fuse else mode)
    if f"mode={mode}" not in err or f"fuse={int(fuse)}" not in err:
        fail(f"{label}: the server did not run mode={mode} fuse={int(fuse)}")
    if f"attn={attn}" not in err:
        fail(f"{label}: the engine did not resolve attn={attn}")
    if sorted(r["id"] for r in recs) != list(range(len(prompts))):
        fail(f"{label}: {len(recs)} records for {len(prompts)} prompts")
    for r in recs:
        if r["prompt"] != prompts[r["id"]] or not (
                0 <= r["n_tokens"] <= max_tokens):
            fail(f"{label}: bad record {r}")
    if not any(r["n_tokens"] for r in recs):
        fail(f"{label}: no request generated a token")
    agg = re.search(r"(\d+) requests, (\d+) tokens in ([0-9.]+)s "
                    r"\(([0-9.]+) tok/s aggregate\)", err)
    pms = sorted(r["prompt_ms"] for r in recs)
    gms = sorted(r["generate_ms"] for r in recs)
    run.update(tokens=sum(r["n_tokens"] for r in recs),
               tok_s=float(agg.group(4)) if agg else None,
               prompt_ms_median=statistics.median(pms), prompt_ms_max=pms[-1],
               generate_ms_median=statistics.median(gms),
               generate_ms_max=gms[-1])
    log(f"{label}: {len(recs)} requests, {run['tokens']} tokens, "
        f"{run['blocks']} prefill blocks, {run['steps']} decode steps, "
        f"launches { {k: n for k, n in run['launches'].items() if n} }, "
        f"wall {run['wall']:.2f} s, aggregate {run['tok_s']} tok/s, "
        f"prompt_ms median {run['prompt_ms_median']} max "
        f"{run['prompt_ms_max']}, generate_ms median "
        f"{run['generate_ms_median']} max {run['generate_ms_max']}")
    return recs, run


def untimed(recs):
    """The records without their timing fields, in stdout order."""
    return [{k: r[k] for k in ("id", "prompt", "text", "n_tokens")}
            for r in recs]


def phase_serving(torch, path: str, workdir: Path):
    """The serving path through qwen3_tpu_torch.serve.main, each run with
    the launch-count check: every default (--batch 8 -c 1024, pallas-fast,
    int8 KV, --attn auto -> fused) on 16 prompts (two waves of admission),
    SERVE_TOKENS each, greedy, then seeded twice with equal records; --batch
    64 -c 512 on 64 prompts (batched admission, 8 rows a forward) for 32
    tokens; --batch 1 -c 32768 on the 8378-token prompt (auto -> flash: the
    two-segment flash kernel at depth >= 8378); a BatchedChat with two
    conversations of two turns and a completion interleaved; and batch
    invariance: one request served alone, among 7 others admitted serially,
    and among 7 admitted with it in one [8, 128] block gives the same
    tokens, greedy and seeded. Returns the runs."""
    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request
    from qwen3_tpu_torch.runtime.batched_chat import BatchedChat

    base = [path, "--device", "cuda"]
    runs = {}
    prompts = serve_prompts(16, 5, 30, 1)
    recs, runs["serve_greedy"] = checked_serve(
        torch, "serve greedy (defaults, 16 prompts)",
        base + ["-t", "0", "-s", "42", "--max-tokens", str(SERVE_TOKENS)],
        prompts, workdir, "fused", SERVE_TOKENS)
    seeded = base + ["-t", "0.8", "-p", "0.9", "-s", "7", "--max-tokens",
                     str(SERVE_TOKENS)]
    rec1, runs["serve_seeded_1"] = checked_serve(
        torch, "serve seeded run 1", seeded, prompts, workdir, "fused",
        SERVE_TOKENS)
    rec2, runs["serve_seeded_2"] = checked_serve(
        torch, "serve seeded run 2", seeded, prompts, workdir, "fused",
        SERVE_TOKENS)
    if untimed(rec1) != untimed(rec2):
        fail("serve seeded: the two runs printed different records")
    _, runs["serve_b64"] = checked_serve(
        torch, "serve --batch 64 -c 512 (64 prompts)",
        base + ["--batch", "64", "-c", "512", "-t", "0.8", "-s", "3",
                "--max-tokens", "32"], serve_prompts(64, 5, 30, 2),
        workdir, "fused", 32)
    _, runs["serve_long"] = checked_serve(
        torch, "serve --batch 1 -c 32768 (8378-token prompt)",
        base + ["--batch", "1", "-c", "32768", "-t", "0.8", "-s", "5",
                "--max-tokens", "32"], [LONG_PROMPT.strip()], workdir,
        "flash", 32)

    def chat():
        # a 192-token context bounds the turns' length (a turn runs to a
        # stop token or the context's end)
        eng = BatchedEngine(path, max_batch=4, seq_len=192,
                            mode="pallas-fast", kv_dtype="int8",
                            temperature=0.8, device="cuda")
        conv = BatchedChat(eng)
        a = conv.new_conversation(seed=11, system_prompt="You are brief.")
        b = conv.new_conversation(seed=22)
        replies = []
        for i, turn in enumerate(("Tell me about the clockmaker.",
                                  "And the children?")):
            ra, rb = conv.submit_turn(a, turn), conv.submit_turn(b, turn)
            if i == 0:
                eng.submit(Request(prompt=PROMPT[:120], seed=5,
                                   max_tokens=24))
            done = eng.run()
            conv.finish_turn(a, ra)
            conv.finish_turn(b, rb)
            replies.append((len(done), len(ra.out_ids), len(rb.out_ids),
                            a.pos, b.pos))
        return replies

    replies, runs["chat"] = checked(torch, "BatchedChat", chat)
    log(f"BatchedChat: per turn (requests finished, reply tokens a, b, "
        f"positions a, b) {replies}, launches "
        f"{ {k: n for k, n in runs['chat']['launches'].items() if n} }")
    if [r[0] for r in replies] != [3, 2] or not all(
            r[1] and r[2] for r in replies):
        fail(f"BatchedChat: turns {replies}")

    # batch invariance: request 0 alone, then among 7 others whose prompts
    # need two prefill blocks (so its own admission is the same [1, 128]
    # block); then among 7 of its own plan, admitted as one [8, 128] block
    solo = serve_prompts(1, 8, 12, 3)
    longer = serve_prompts(7, 45, 55, 4)
    same_plan = serve_prompts(7, 8, 25, 5)
    for mode, flags in (("greedy", ["-t", "0"]),
                        ("seeded", ["-t", "0.8", "-p", "0.9"])):
        argv = base + flags + ["-s", "9", "--max-tokens", "32"]
        outs = {}
        for name, ps in (("alone", solo), ("among 7", solo + longer),
                         ("batched admission", solo + same_plan)):
            recs, runs[f"inv_{mode}_{name}"] = checked_serve(
                torch, f"invariance {mode}, {name}", argv, ps, workdir,
                "fused", 32)
            outs[name] = next(r for r in recs if r["id"] == 0)["text"]
        log(f"batch invariance, {mode}: request 0 alone "
            f"{outs['alone']!r:.60} ... among 7 others equal: "
            f"{outs['among 7'] == outs['alone']}; in a batched admission "
            f"equal: {outs['batched admission'] == outs['alone']}")
        if outs["among 7"] != outs["alone"]:
            fail(f"batch invariance, {mode}: request 0's tokens depend on "
                 f"its batch-mates")
        if outs["batched admission"] != outs["alone"]:
            fail(f"batch invariance, {mode}: request 0's tokens in a batched "
                 f"[8, 128] admission differ from its serial admission")
    return runs


@contextlib.contextmanager
def fuse_env(on: bool = True):
    """QWEN3_TPU_FUSE set for the entry points run inside (they read it
    once, at their start), and restored after."""
    old = os.environ.get("QWEN3_TPU_FUSE")
    os.environ["QWEN3_TPU_FUSE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QWEN3_TPU_FUSE")
        else:
            os.environ["QWEN3_TPU_FUSE"] = old


def check_route(label, run, route):
    """Every pass of the run took the matmul route `route` (models.qwen3
    CALLS "mm_" keys: a mode, or "fused")."""
    calls = run["calls"]
    if calls["mm_" + route] != run["blocks"] + run["steps"]:
        fail(f"{label}: passes {calls}; want every pass on the {route} "
             f"matmuls")


def phase_modes(torch, path: str, workdir: Path):
    """The other modes' paths, each run with the launch-count check: the
    CLI at qwen3-0.6b full size with --qmode exact, bf16 and pallas-int8 (a
    short prompt at -c 512, 16 tokens; greedy, then seeded twice with equal
    stdout); the CLI at its defaults with QWEN3_TPU_FUSE=1 in pallas and
    pallas-fast (greedy, equal to the same command without it; pallas also
    seeded twice); serve.py at its defaults (pallas-fast, B = 8) with
    QWEN3_TPU_FUSE=1 on 8 prompts, greedy, equal to the run without it; and
    serve.py --qmode pallas-int8 at B = 8, seeded twice with equal records.
    With fuse on, every pass launches 113 fused kernels and no unfused
    matmul. Returns the runs."""
    base = [path, "--device", "cuda"]
    prompt = PROMPT[:200]
    runs = {}
    for qmode in ("exact", "bf16", "pallas-int8"):
        argv = base + ["-m", "completion", "-i", prompt, "-c", "512",
                       "--max-tokens", "16", "--qmode", qmode]
        out, _, runs[f"{qmode}_greedy"] = checked_run(
            torch, f"--qmode {qmode} greedy", argv + ["-t", "0", "-s", "42"])
        if not out.startswith(prompt.encode()):
            fail(f"--qmode {qmode}: stdout does not start with the prompt")
        seeded = argv + ["-t", "0.8", "-p", "0.9", "-s", "7"]
        out1, _, runs[f"{qmode}_seeded_1"] = checked_run(
            torch, f"--qmode {qmode} seeded run 1", seeded)
        out2, _, runs[f"{qmode}_seeded_2"] = checked_run(
            torch, f"--qmode {qmode} seeded run 2", seeded)
        if out1 != out2:
            fail(f"--qmode {qmode} seeded: the two runs printed different "
                 f"bytes")
        for name in ("greedy", "seeded_1", "seeded_2"):
            check_route(f"--qmode {qmode} {name}", runs[f"{qmode}_{name}"],
                        qmode)
    for qmode in ("pallas", "pallas-fast"):
        argv = base + ["-m", "completion", "-i", prompt, "--qmode", qmode,
                       "-t", "0", "-s", "42", "--max-tokens", "32"]
        plain, _, runs[f"{qmode}_unfused"] = checked_run(
            torch, f"--qmode {qmode} greedy, fuse off", argv)
        with fuse_env():
            fused, err, runs[f"{qmode}_fused"] = checked_run(
                torch, f"--qmode {qmode} greedy, QWEN3_TPU_FUSE=1", argv)
        if "fuse=1" not in err:
            fail(f"--qmode {qmode}: the CLI did not take QWEN3_TPU_FUSE=1")
        check_route(f"--qmode {qmode} fused", runs[f"{qmode}_fused"],
                    "fused")
        log(f"--qmode {qmode} greedy: fused stdout equals unfused: "
            f"{fused == plain}")
        if fused != plain:
            fail(f"--qmode {qmode}: greedy tokens with QWEN3_TPU_FUSE=1 "
                 f"differ from those without")
    seeded = base + ["-m", "completion", "-i", prompt, "-t", "0.8", "-p",
                     "0.9", "-s", "7", "--max-tokens", "32"]
    with fuse_env():
        out1, _, runs["fused_seeded_1"] = checked_run(
            torch, "QWEN3_TPU_FUSE=1 seeded run 1", seeded)
        out2, _, runs["fused_seeded_2"] = checked_run(
            torch, "QWEN3_TPU_FUSE=1 seeded run 2", seeded)
    if out1 != out2:
        fail("QWEN3_TPU_FUSE=1 seeded: the two runs printed different bytes")

    prompts = serve_prompts(8, 5, 30, 6)
    argv = base + ["-t", "0", "-s", "42", "--max-tokens", "32"]
    plain, runs["serve_unfused"] = checked_serve(
        torch, "serve greedy (defaults, 8 prompts), fuse off", argv, prompts,
        workdir, "fused", 32)
    with fuse_env():
        fused, runs["serve_fused"] = checked_serve(
            torch, "serve greedy (defaults, 8 prompts), QWEN3_TPU_FUSE=1",
            argv, prompts, workdir, "fused", 32, fuse=True)
    if untimed(fused) != untimed(plain):
        fail("serve with QWEN3_TPU_FUSE=1 printed other records than "
             "without")
    argv = base + ["--qmode", "pallas-int8", "-t", "0.8", "-p", "0.9", "-s",
                   "7", "--max-tokens", "32"]
    rec1, runs["serve_int8_1"] = checked_serve(
        torch, "serve --qmode pallas-int8 seeded run 1", argv, prompts,
        workdir, "fused", 32, mode="pallas-int8")
    rec2, runs["serve_int8_2"] = checked_serve(
        torch, "serve --qmode pallas-int8 seeded run 2", argv, prompts,
        workdir, "fused", 32, mode="pallas-int8")
    if untimed(rec1) != untimed(rec2):
        fail("serve --qmode pallas-int8 seeded: the two runs printed "
             "different records")
    return runs


QUALITY_DEPTHS = (8192, 16384)  # the depth rows phase 4b runs


def phase_quality(torch, path: str, workdir: Path):
    """Phase 4b: the port's quality table on the synthetic qwen3-0.6b at
    -c 1024, in two calls: the default modes (exact, pallas, pallas-fast,
    bf16) and the pallas+int8kv row, whose gate must pass; then exact and
    pallas-int8 (the JAX package's unadopted experiment), whose row is
    logged whether or not it passes. Then the table at depth
    (tools/quality_depth.py, exact, pallas and pallas+int8kv) at each of
    QUALITY_DEPTHS on the same checkpoint (its header allows 40960
    positions), whose gate must pass. Returns the JSON objects."""
    from qwen3_tpu_torch.tools import quality_depth, quality_table

    results = {}
    for label, extra, must_pass in (
            ("default modes", [], True),
            ("pallas-int8", ["--modes", "exact,pallas-int8", "--no-int8-kv"],
             False)):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = quality_table.main([path, "-c", "1024", "--device", "cuda"]
                                    + extra)
        line = out.getvalue().strip().splitlines()[-1]
        res = json.loads(line)
        log(f"quality table, {label}: rc {rc}, "
            f"{time.perf_counter() - t0:.1f} s: {line}")
        if must_pass and (rc != 0 or not res["pass"]):
            fail(f"quality table, {label}: the gate failed:\n"
                 f"{err.getvalue()}")
        results[label] = res
    out_json = workdir / "quality_depth.json"
    for ctx in QUALITY_DEPTHS:
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = quality_depth.main([path, str(ctx), "--out", str(out_json),
                                     "--preset", "qwen3-0.6b", "--device",
                                     "cuda"])
        table = json.loads(out_json.read_text())["tables"][
            f"qwen3-0.6b@{ctx}"]
        log(f"quality at depth, qwen3-0.6b@{ctx}: rc {rc}, "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(table)}")
        if rc != 0 or not table["pass"]:
            fail(f"quality at depth {ctx}: the gate failed:\n"
                 f"{err.getvalue()[-3000:]}")
        results[f"qwen3-0.6b@{ctx}"] = table
    return results


PROBE_LAYERS = (0, 17, 35)


def phase_probe(torch):
    """The DMA probe's path (qwen3_tpu_torch/tools/probe_dma.py) at its own
    full-width configuration: qwen3-4b's parameters generated on the card,
    w13 [36, 19456, 2560] int8, 64 calls a row, call i reading layer i % 36.
    The launch counts are set to 0 just before it and read just after.
    Then, outside the counted run: each pure-read kernel's checksum equal
    to the plain version's at layers PROBE_LAYERS, for n_buf 2, 3 and 4;
    no row may read faster than 1.05 x 3.35 TB/s (that would mean dropped
    loads or L2 hits); the plain version's time for one layer, and as a
    yardstick a device-to-device copy_ of one layer (its read and write
    bytes counted). Returns (rows, counts, plain ms, layer bytes)."""
    from qwen3_tpu_torch.tools import probe_dma as pd

    t0 = time.perf_counter()
    reset_counts()
    rows, w_q, nbytes = pd.run_probe(torch.device("cuda"))
    torch.cuda.synchronize()
    counts = read_counts()
    for label, ms, gbs in rows:
        log(f"probe {label:24s} {ms:7.3f} ms/layer  {gbs:6.1f} GB/s")
    log(f"probe path launches: { {k: c for k, c in counts.items() if c} }")
    if min(counts[k] for k in ("stacked", "pure_read_stacked",
                               "pure_read_manual")) == 0:
        fail("a kernel of the probe path was never launched")
    limit = 1.05 * HBM_BYTES_PER_S / 1e9
    for label, ms, gbs in rows:
        if gbs > limit:
            fail(f"probe {label}: {gbs:.1f} GB/s is past 1.05 x the card's "
                 f"memory rate ({limit:.0f} GB/s)")
    for layer in PROBE_LAYERS:
        want = pd.pure_read_plain(w_q, layer)
        got = {"stacked": pd.pure_read_stacked(w_q, layer)}
        for n_buf in pd.N_BUFS:
            got[f"manual {n_buf}"] = pd.pure_read_manual(w_q, layer, n_buf)
        torch.cuda.synchronize()
        for name, g in got.items():
            if not torch.equal(g, want):
                fail(f"probe checksum, {name}, layer {layer}: kernel != "
                     f"plain")
    plain_ms = device_ms(torch, lambda i: pd.pure_read_plain(
        w_q, i % w_q.shape[0]), reps=5)
    dst = torch.empty_like(w_q[0])
    copy_ms = device_ms(torch, lambda i: dst.copy_(w_q[i % w_q.shape[0]]))
    log(f"probe checksums equal the plain version's at layers "
        f"{list(PROBE_LAYERS)}, n_buf {list(pd.N_BUFS)}; plain "
        f"{plain_ms:.3f} ms/layer; yardstick copy_ of one layer "
        f"{copy_ms:.4f} ms, {2 * nbytes / copy_ms / 1e6:.1f} GB/s read + "
        f"written; {time.perf_counter() - t0:.1f} s")
    del w_q, dst
    torch.cuda.empty_cache()
    return rows, counts, plain_ms, nbytes


def phase_host_tools(torch, path: str, workdir: Path):
    """The host tools on the phases' checkpoint: model_check and
    tokenizer_check (rc 0, every round trip ok); the native C++ encode
    against the Python encode on every prompt the phases feed (the 8378-token
    one included), both encode times logged; and the CLI with --profile
    (launch counts checked), which must leave a trace with kernel events and
    print the same tokens as the same run without it."""
    from qwen3_tpu_torch.tokenizer import Tokenizer
    from qwen3_tpu_torch.tools import model_check, tokenizer_check

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = model_check.main([path])
    if rc != 0:
        fail(f"model_check returned {rc}:\n{err.getvalue()}")
    log(f"model_check: rc 0, {err.getvalue().strip().splitlines()[-1]}")
    out = io.StringIO()
    texts = [PROMPT, "<|im_start|>user\nhi<|im_end|>", "héllo wörld"]
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tokenizer_check.main([path] + texts)
    if rc != 0 or out.getvalue().count("[ok]") != len(texts):
        fail(f"tokenizer_check returned {rc}:\n{out.getvalue()}")
    log(f"tokenizer_check: rc 0, {len(texts)} round trips ok")

    tok = Tokenizer.from_file(path)
    if tok._native is None:
        fail("the native tokenizer did not build")
    prompts = ([PROMPT, LONG_PROMPT, LONG_PROMPT.strip(), PROMPT[:200],
                PROMPT[:120], PROMPT[:60], "You are brief.",
                "Tell me about the clockmaker.", "And the children?"]
               + [PROMPT[:60 + 25 * i] for i in range(8)]
               + [p for args in ((16, 5, 30, 1), (64, 5, 30, 2), (1, 8, 12, 3),
                                 (7, 45, 55, 4), (7, 8, 25, 5), (8, 5, 30, 6))
                  for p in serve_prompts(*args)])
    t_native = t_python = 0.0
    longest = 0
    for text in prompts:
        t0 = time.perf_counter()
        ids = tok.encode(text)
        t1 = time.perf_counter()
        want = tok.encode_python(text)
        t_python += time.perf_counter() - t1
        t_native += t1 - t0
        if ids != want:
            fail(f"native encode != Python encode on {text[:60]!r}")
        longest = max(longest, len(ids))
    log(f"native encode equals the Python encode on {len(prompts)} prompts "
        f"(longest {longest} tokens): native {t_native * 1e3:.1f} ms, "
        f"Python {t_python * 1e3:.1f} ms in all")

    argv = [path, "--device", "cuda", "-m", "completion", "-i", PROMPT[:200],
            "-t", "0", "-s", "42", "-c", "512", "--max-tokens", "16"]
    plain, _, _ = checked_run(torch, "profile off", argv)
    pdir = workdir / "profile"
    traced, err, _ = checked_run(torch, "--profile", argv + [
        "--profile", str(pdir)])
    if f"[Profile] tracing to {pdir}" not in err:
        fail("--profile: no [Profile] line")
    if traced != plain:
        fail("--profile: other tokens than the same run without it")
    traces = sorted(pdir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--profile: {len(traces)} trace files in {pdir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    log(f"--profile: the same {len(plain)} stdout bytes; trace "
        f"{traces[0].name}, {traces[0].stat().st_size / 1e6:.1f} MB, "
        f"{n_kernels} kernel events")
    if n_kernels == 0:
        fail("--profile: the trace holds no kernel events")


# -- phase 4e ------------------------------------------------------------------

CHUNK_SEED = 7                 # the seeded runs' RNG seed
DEEP_TOKENS = FLASH_DEPTH      # the side program's deep prompt: its prefill
                               # blocks start below 8192, its decode at it
L4B = 36                       # qwen3-4b's layers
# bench.py's headline settings (its 256 tokens cut to 64 for time)
BENCH_4B = dict(ctx=1024, chunk=32, tokens=64,
                deep_rows=32768, depth=8192, deep_chunks=2)


def prompt_of_tokens(tok, n: int) -> str:
    """A prompt that encodes to exactly n ids: the longest word prefix of
    LONG_PROMPT's text within n ids, then single "x" bytes, which no merge
    of the synthetic tokenizer takes."""
    words = (LONG_PROMPT * 2).split()
    lo, hi = 0, len(words)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if len(tok.encode(" ".join(words[:mid]))) <= n:
            lo = mid
        else:
            hi = mid - 1
    text = " ".join(words[:lo])
    text += "x" * (n - len(tok.encode(text)))
    if len(tok.encode(text)) != n:
        fail(f"no prompt of exactly {n} tokens")
    return text


def no_sync(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a call that
    synchronizes with the host (a read, a blocking copy) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def clone_cache(cache):
    from qwen3_tpu_torch.runtime import kvcache

    vals, sc = kvcache.split(cache)
    return kvcache.join(vals.clone(), None if sc is None else sc.clone())


def phase_chunk_checks(torch, path: str):
    """decode_chunk (the B = 1 chunk, its loop on the card) against
    decode_chunk_host, the same steps one at a time with a host read after
    each, bit for bit: packed, token, position, RNG state and every KV row
    below the position. qwen3-0.6b (mode pallas, int8 KV, seeded at t 0.8),
    an 826-token prefill, chunks of 16: a free chunk, then under
    torch.cuda.set_sync_debug_mode("error") (only the read of packed
    outside it) a stop drawn inside the chunk, the limit without
    emit_at_limit and the limit with it. Not counted as a path: these runs
    hold the chunk against its plain loop."""
    from qwen3_tpu_torch.runtime import kvcache
    from qwen3_tpu_torch.runtime.decode_loop import (
        decode_chunk,
        decode_chunk_host,
    )
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig
    from qwen3_tpu_torch.runtime.xorshift import (
        from_device_state,
        to_device_state,
    )

    t0 = time.perf_counter()
    eng = Engine(EngineConfig(path=path, temperature=0.8, seed=CHUNK_SEED,
                              mode="pallas", kv_dtype="int8", seq_len=1024,
                              device="cuda"))
    ids = eng.tokenizer.encode(PROMPT)
    eng.reset(batch=1)
    first = eng._first_token(eng._prefill(ids, 0), 0)
    k0, v0 = eng._kv
    pos0, rng0 = len(ids), eng._rng
    sp = eng.tokenizer.special
    base = dict(mode="pallas", chunk=16, temperature=eng.sampler.temperature,
                top_p=eng.sampler.top_p, greedy=False, bos=sp.bos,
                eos=sp.eos, top_k=64)

    def compare(label, limit, guard, **kw):
        kw = {**base, **kw}
        want = decode_chunk_host(eng.params, eng.model_cfg,
                                 clone_cache(k0), clone_cache(v0), first,
                                 pos0, limit, rng0, **kw)
        k, v = clone_cache(k0), clone_cache(v0)
        hi, lo = to_device_state(rng0, eng.device)
        tok = torch.full((1,), first, dtype=torch.int64, device=eng.device)

        def run():
            return decode_chunk(eng.params, eng.model_cfg, k, v, tok, pos0,
                                limit, hi, lo, **kw)

        got = no_sync(torch, run) if guard else run()
        packed = got[0].cpu().numpy()          # the one read
        w_packed, wk, wv, w_tok, w_pos, w_rng = want
        if packed.tolist() != w_packed.tolist():
            fail(f"chunk {label}: packed {packed.tolist()}, host loop "
                 f"{w_packed.tolist()}")
        state = (int(got[3][0]), int(got[4]), from_device_state(*got[5:]))
        if state != (w_tok, w_pos, w_rng):
            fail(f"chunk {label}: (token, pos, rng) {state}, host loop "
                 f"{(w_tok, w_pos, w_rng)}")
        for a, b in zip(kvcache.tensors(got[1]) + kvcache.tensors(got[2]),
                        kvcache.tensors(wk) + kvcache.tensors(wv)):
            if not torch.equal(a[:, :, :w_pos], b[:, :, :w_pos]):
                fail(f"chunk {label}: a KV row below {w_pos} differs")
        log(f"chunk {label}: {int(packed[-2])} ids, done {int(packed[-1])}, "
            f"pos {w_pos}; equal to the host loop"
            + (" (no sync inside)" if guard else ""))
        return packed

    packed = compare("free", 1024, False)
    free = packed[:int(packed[-2])].tolist()
    at = next((i for i in range(3, len(free)) if free[i] not in free[:i]),
              None)
    if at is None:
        fail(f"chunk: no new id past step 3 in the free stream {free}")
    compare(f"stop at step {at}", 1024, True, eos=free[at])
    compare("limit", pos0 + 5, True)
    compare("limit, emit_at_limit", pos0 + 5, True, emit_at_limit=True)
    del eng, k0, v0
    torch.cuda.empty_cache()
    log(f"chunk checks: {time.perf_counter() - t0:.1f} s")


def phase_decode_programs(torch, path: str):
    """The single-stream engine's fused and side programs at qwen3-0.6b
    (the phase 4 checkpoint; mode pallas, int8 KV), each run with the
    launch-count check (want_launches; every step of the fused chunk is a
    forward_step pass):
    1. Engine(decode_impl="fused"), chunks of 16: a greedy completion and a
       seeded one twice (reset_rng between them), equal ids;
    2. Engine(decode_impl="side") against BatchedEngine(side_buffer=True)
       at B = 1, seeded, the same ids: below depth 8192 (-c 1024, both on
       the dense two-segment attention) and from depth 8192 (an 8192-token
       prompt, whose prefill blocks all start below 8192, so both engines
       prefill dense; every decode step runs the two-segment flash kernel).
    Returns the runs."""
    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig

    runs = {}

    def engine(**kw):
        base = dict(path=path, temperature=0.8, seed=CHUNK_SEED,
                    mode="pallas", kv_dtype="int8", seq_len=1024,
                    device="cuda")
        return Engine(EngineConfig(**{**base, **kw}))

    eng = engine(temperature=0.0, decode_chunk=16, decode_impl="fused")
    greedy, runs["fused_greedy"] = checked(
        torch, "fused greedy", lambda: eng.generate(PROMPT, max_tokens=48))
    eng = engine(decode_chunk=16, decode_impl="fused")
    seeded, runs["fused_seeded_1"] = checked(
        torch, "fused seeded 1", lambda: eng.generate(PROMPT, max_tokens=48))
    eng.reset_rng()
    again, runs["fused_seeded_2"] = checked(
        torch, "fused seeded 2", lambda: eng.generate(PROMPT, max_tokens=48))
    if seeded.ids != again.ids:
        fail("fused seeded: the two runs gave different ids")
    for name, res in (("fused_greedy", greedy), ("fused_seeded_1", seeded)):
        run = runs[name]
        if run["calls"]["forward_step"] != run["steps"] or not res.n_generated:
            fail(f"{name}: passes {run['calls']}; want every step a "
                 f"forward_step and some tokens")
        log(f"{name}: {res.n_generated} tokens, {run['steps']} chunk steps, "
            f"launches { {k: n for k, n in run['launches'].items() if n} }, "
            f"generate {res.generate_ms:.1f} ms, "
            f"{1e3 * res.n_generated / res.generate_ms:.2f} tok/s")
    del eng
    torch.cuda.empty_cache()

    for label, seq_len, attn in (("below 8192", 1024, "dense"),
                                 ("from 8192", 8448, "flash")):
        eng = engine(seq_len=seq_len, decode_impl="side")
        prompt = (PROMPT if seq_len <= FLASH_DEPTH else
                  prompt_of_tokens(eng.tokenizer, DEEP_TOKENS))
        side, run = checked(torch, f"side {label}",
                            lambda: eng.generate(prompt, max_tokens=32))
        kind = {"dense": "decode_forward",
                "flash": "decode_forward_two_segment"}[attn]
        if run["calls"][kind] != run["steps"]:
            fail(f"side {label}: passes {run['calls']}; want every step "
                 f"{attn}")
        runs[f"side {label}"] = run
        beng = BatchedEngine(path, max_batch=1, seq_len=seq_len,
                             mode="pallas", temperature=0.8, top_p=0.9,
                             kv_dtype="int8", prefill_bucket=64, attn=attn,
                             model_cfg=eng.model_cfg, params=eng.params,
                             device="cuda")
        if beng.attn != attn:
            fail(f"BatchedEngine resolved attn={beng.attn}, want {attn}")
        req = beng.submit(Request(prompt=prompt, seed=CHUNK_SEED,
                                  max_tokens=32))
        (_, runs[f"batched {label}"]) = checked(torch, f"batched {label}",
                                                beng.run)
        if req.prompt_ids + req.out_ids != side.ids:
            fail(f"side {label}: ids differ from BatchedEngine("
                 f"side_buffer=True) at B = 1")
        log(f"side {label}: {len(side.ids)} ids ({side.n_generated} "
            f"generated) equal BatchedEngine(side_buffer=True)'s, attn "
            f"{attn}, launches "
            f"{ {k: n for k, n in run['launches'].items() if n} }")
        del eng, beng
        torch.cuda.empty_cache()
    return runs


def chunk_profile(torch, label: str, chunk_fn, steps: int, trace: str):
    """Where a chunk's time goes: chunk_fn() (one decode_chunk call and the
    read of its packed ids, which it returns) once to warm, once timed alone, once under
    torch.profiler, read from its Chrome trace. Reports wall per token,
    device busy per step, kernels per step and the device's idle share (busy
    from the trace, wall from the run without the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    chunk_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = int(chunk_fn()[-2])
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk_fn()
        torch.cuda.synchronize()
    got = trace_busy(prof, trace)
    if got is None:
        log(f"{label} profile: the trace holds no kernel events; device "
            f"time not measured")
        return None
    busy, n_kernels, span, by_name = got
    matmul = sum(v for k, v in by_name.items()
                 if k.startswith(MATMUL_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    before = PROFILE_BEFORE.get(label, (None, None))
    out = dict(label=label, steps=steps, tokens=n, wall_ms=wall_ms,
               wall_ms_per_token=wall_ms / max(n, 1),
               device_busy_ms_per_step=busy / 1e3 / steps,
               before_device_busy_ms_per_step=before[1],
               matmul_kernel_ms_per_step=matmul / 1e3 / steps,
               kernels_per_step=n_kernels / steps,
               before_kernels_per_step=before[0],
               device_idle_share=1.0 - busy / 1e3 / wall_ms,
               profiled_idle_share=1.0 - busy / span,
               top_kernels_ms={k: v / 1e3 for k, v in top})
    log("chunk profile " + json.dumps(out))
    return out


def phase_fused_4b(torch, card: str, workdir: Path):
    """The fused chunk at qwen3-4b's full width (PRESETS["qwen3-4b"],
    parameters made on the card from seed 0 by io/device_synth.py), with
    bench.py's headline settings: mode pallas, a 1024-row bf16 cache,
    greedy from token 7 at position 0, chunks of 32, one warm chunk, then
    BENCH_4B["tokens"] tokens timed; then an int8 cache of 32768 rows (values 1, as
    bench.py fills it), flash decode from depth 8192, one warm chunk and two
    timed. Every step must launch 4 x 36 layer matmuls, 1 classifier matmul
    and 3 x 36 + 1 norms (norm_launches; and at depth 36 flash decodes); a profile of one
    warm chunk at ctx 1024 (chunk_profile). Returns (tok/s by run,
    profile)."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.device_synth import synth_device_params
    from qwen3_tpu_torch.models.qwen3 import init_kv_cache
    from qwen3_tpu_torch.runtime.decode_loop import chunk_steps, decode_chunk
    from qwen3_tpu_torch.runtime.xorshift import seed_to_device

    t0 = time.perf_counter()
    cfg = PRESETS["qwen3-4b"]
    b = BENCH_4B
    dev = torch.device("cuda")
    params = synth_device_params(cfg, b["deep_rows"], seed=0)
    torch.cuda.synchronize()
    log(f"qwen3-4b parameters on the card in {time.perf_counter() - t0:.1f} "
        f"s: {sum(t.numel() * t.element_size() for t in params.values()) / 1e9:.2f} GB")
    kw = dict(mode="pallas", chunk=b["chunk"], temperature=1e-6, top_p=0.9,
              greedy=True, bos=cfg.vocab_size - 1, eos=cfg.vocab_size - 2,
              top_k=64)
    out = {}

    def decode(label, kv_dtype, rows, pos, attn, tokens=None, chunks=None):
        k, v = init_kv_cache(cfg, 1, rows, kv_dtype, dev)
        if kv_dtype == "int8":
            k[0].fill_(1)
            v[0].fill_(1)
        hi, lo = seed_to_device(3, dev)
        tok = torch.full((1,), 7, dtype=torch.int64, device=dev)

        def chunk():
            nonlocal k, v, tok, hi, lo, pos
            packed, k, v, tok, _, hi, lo = decode_chunk(
                params, cfg, k, v, tok, pos, rows, hi, lo, attn=attn, **kw)
            row = packed.cpu()
            pos = min(pos + int(row[-2]), rows)
            return row

        chunk()                                    # warm
        before, steps, emitted, n_chunks = read_counts(), 0, 0, 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while (emitted < tokens) if tokens else (n_chunks < chunks):
            steps += chunk_steps(pos, rows, b["chunk"])
            row = chunk()
            emitted += int(row[-2])
            n_chunks += 1
            if bool(row[-1]) or int(row[-2]) == 0:
                break
        dt = time.perf_counter() - t1
        got = {k_: c - before[k_] for k_, c in read_counts().items()}
        want = {"stacked": 4 * L4B * steps, "tiled": steps,
                **norm_launches(steps, 0, L4B),
                "flash_decode": L4B * steps if attn == "flash" else 0}
        if any(got[k_] != n for k_, n in want.items()) or any(
                c for k_, c in got.items() if k_ not in want):
            fail(f"qwen3-4b {label}: launches {got}, want {want} for "
                 f"{steps} steps")
        out[label] = emitted / dt
        log(f"qwen3-4b {label}: {emitted} tokens in {n_chunks} chunks "
            f"({steps} steps) in {dt:.3f} s: {emitted / dt:.2f} tok/s, "
            f"{1e3 * dt / max(emitted, 1):.2f} ms/token ({card}); launches "
            f"{ {k_: c for k_, c in got.items() if c} }")
        return chunk

    chunk = decode("ctx 1024, bf16 KV, dense", "bfloat16", b["ctx"], 0,
                   "dense", tokens=b["tokens"])
    prof = chunk_profile(torch, "qwen3-4b fused chunk, ctx 1024",
                         chunk, b["chunk"], str(workdir / "chunk4b"))
    decode(f"depth {b['depth']}, int8 KV, flash, {b['deep_rows']} rows",
           "int8", b["deep_rows"], b["depth"], "flash",
           chunks=b["deep_chunks"])
    del params, chunk
    torch.cuda.empty_cache()
    log(f"qwen3-4b phase: {time.perf_counter() - t0:.1f} s")
    return out, prof


# -- phase 4f: tensor and data parallelism -------------------------------------

TP = 2                         # the ranks of the tp paths
SHARD_PRESETS = ("qwen3-0.6b", "qwen3-4b")
SHARD_BATCHES = (1, 8, 512)    # decode, serving's B = 8, a prefill block
# the decode attention kernels at a rank's heads: qwen3-0.6b at tp = 2 (8
# heads over 4 kv heads) and qwen3-4b at tp = 8 (4 heads over 1)
SHARD_ATTN = ((8, 4), (4, 1))
SHARD_ROWS = 8448              # a cache past depth 8192, in 256-row tiles
TP_TOKENS = 8                  # tokens a tp CLI run generates (-c 4096)
TP_SERVE_TOKENS = 8            # tokens a tp serve.py request generates
TP_4B_TOKENS = 32              # qwen3-4b's timed tokens at tp = 2
# the prefill's last logits at tp = 2 against tp = 1 (826 tokens, 28
# layers): within TP_LOGIT_TOL * max|logits|. The wo and w2 sums run in two
# chains, so an fp32 ulp can move a Q8 activation a step (a rounding flip,
# ROADMAP Queue C #1) in any later quantization; the first reduction (layer
# 0's wo, before any quantization sees a tp sum) holds the JAX package's
# 2e-5 (TP_LAYER_TOL)
TP_LOGIT_TOL = 2e-2
TP_LAYER_TOL = 2e-5


def shard_matrices(preset):
    """One tp = 2 rank's layer matrices and classifier, (n = in, d = out)."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.parallel.shard_layout import local_config

    loc = local_config(PRESETS[preset], TP)
    return {"wqkv": (loc.dim, loc.proj_dim + 2 * loc.kv_dim),
            "wo": (loc.proj_dim, loc.dim),
            "w13": (loc.dim, 2 * loc.hidden_dim),
            "w2": (loc.hidden_dim, loc.dim),
            "classifier": (loc.dim, loc.vocab_size)}


def phase_shard_kernels(torch):
    """(a) Every matmul kernel of the tp paths at one tp = 2 rank's shard
    shapes of qwen3-0.6b and qwen3-4b, b = 1, 8 and 512, against its plain
    version bit for bit: the Q8_0 x Q8_0 GEMV and tile path (rows 1, 1b,
    2), pallas-fast (6-7), pallas-int8 (9-10) and the fused kernel, exact
    and fast, with each matrix's prologue (11). qwen3-4b's w2 contracts
    over 4864: one k-tile of 76 groups (every earlier run had 8 a tile).
    Then the decode attention kernels at a rank's heads (SHARD_ATTN): flash
    decode and a 64-row flash prefill block at depth 8192, two-segment
    flash at base 8192, batched decode (fast) at B = 8 over 1152 rows,
    within their phase-3 tolerances. Each shape's time (CUDA events) beside
    its bound. Returns the rows."""
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.norms import rms_inv
    from qwen3_tpu_torch.ops.q8 import quantize_act
    from qwen3_tpu_torch.runtime import kvcache as kvc

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []

    def hold(label, kernel, plain, exact=True, tol=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (
                got if isinstance(got, tuple) else (got,))):
            fail(f"shard {label}: non-finite kernel output")
        if exact:
            diff = (got - want).abs().max().item()
            if not torch.equal(got, want):
                fail(f"shard {label}: kernel != plain (max_abs_diff "
                     f"{diff:.3e})")
            return diff
        diff = (got - want).abs().max().item()
        if diff > tol * max(1.0, want.abs().max().item()):
            fail(f"shard {label}: kernel vs plain max_abs_diff {diff:.3e}")
        return diff

    for preset in SHARD_PRESETS:
        for name, (n, d) in shard_matrices(preset).items():
            stacked = name != "classifier"
            lead = (2,) if stacked else ()
            w_q = torch.randint(-127, 128, lead + (d, n), dtype=torch.int8,
                                device="cuda", generator=gen)
            w_s = 0.02 / 127 * (0.5 + torch.rand(lead + (d, n // G),
                                                 device="cuda", generator=gen))
            wl, sl = (w_q[1], w_s[1]) if stacked else (w_q, w_s)
            prologue = FUSED_PROLOGUES[name]
            width = 2 * n if prologue == "swiglu" else n
            x_all = torch.randn(max(SHARD_BATCHES), width, device="cuda",
                                generator=gen)
            nw = 1 + 0.1 * torch.randn(n, device="cuda", generator=gen)
            for b in SHARD_BATCHES:
                xr = x_all[:b].contiguous()       # the fused kernel's rows
                x = xr[:, :n].contiguous()
                xq, xs = quantize_act(x, G)
                xb = x.to(torch.bfloat16)
                inv = rms_inv(xr) if prologue == "norm" else None
                if stacked:
                    q8q8 = lambda: qm.q8_q8_matmul_stacked(      # noqa: E731
                        xq, xs, w_q, w_s, 1, G)
                    fast = lambda: qm.q8_matmul_stacked_fast(    # noqa: E731
                        xb, w_q, w_s, 1, G)
                    int8 = lambda: qm.q8i8_matmul_stacked(       # noqa: E731
                        x, w_q, w_s, 1, G)
                else:
                    q8q8 = lambda: qm.q8_q8_matmul_tiled(        # noqa: E731
                        xq, xs, w_q, w_s, G)
                    fast = lambda: qm.q8_matmul_tiled_fast(      # noqa: E731
                        xb, w_q, w_s, G)
                    int8 = lambda: qm.q8i8_matmul_tiled(         # noqa: E731
                        x, w_q, w_s, G)
                cases = [
                    ("q8q8", q8q8, lambda: qm.q8q8_matmul_plain(
                        xq, xs, wl, sl, G), bound_ms(b, n, d)),
                    ("fast", fast, lambda: qm.q8_fast_matmul_plain(
                        xb, wl, sl, G), fast_bound_ms(b, n, d)),
                    ("int8", int8, lambda: qm.q8i8_matmul_plain(
                        x, wl, sl, G), int8_bound_ms(b, n, d))]
                for exact in (True, False):
                    cases.append((
                        f"fused_{'exact' if exact else 'fast'}",
                        lambda exact=exact: qm.q8_matmul_fused(
                            xr, wl, sl, G, inv, nw, prologue=prologue,
                            exact=exact),
                        lambda exact=exact: qm.q8_fused_matmul_plain(
                            xr, wl, sl, G, inv, nw, prologue=prologue,
                            exact=exact),
                        fused_bound_ms(b, n, d, prologue, exact)))
                for kind, kernel, plain, (bnd, by) in cases:
                    label = f"{preset} {name} {kind} b={b} n={n} d={d}"
                    diff = hold(label, kernel, plain)
                    row = dict(preset=preset, matrix=name, kernel=kind, b=b,
                               n=n, d=d, groups_per_tile=qm.groups_per_tile(
                                   n, G), max_abs_diff=diff,
                               kernel_ms=device_ms(torch, lambda i: kernel(),
                                                   reps=10),
                               bound_ms=bnd, bound_by=by)
                    if kind == "q8q8" and b > 1:
                        shape, splits = qm.plan_q8q8(b, n, d, G)
                        row.update(tile_rows=qm.TILE_ROWS[shape],
                                   k_splits=splits)
                    rows.append(row)
                    log("shard " + json.dumps(row))
            del w_q, w_s, wl, sl
            torch.cuda.empty_cache()

    for heads, kvh in SHARD_ATTN:
        def cache(slots, n_rows):
            out = []
            for _ in range(2):
                x = torch.randn(1, slots, n_rows, kvh, FLASH_D,
                                device="cuda", generator=gen)
                out.append(kvc.quantize_heads(x))
            (k_, ks_), (v_, vs_) = out
            return k_, v_, ks_, vs_

        depth, t_blk = FLASH_DEPTH, 64
        k, v, ks, vs = cache(1, SHARD_ROWS)
        sk, sv, sks, svs = cache(1, SIDE_C)
        q = torch.randn(1, heads, FLASH_D, device="cuda", generator=gen)
        qp = torch.randn(1, t_blk, heads, FLASH_D, device="cuda",
                         generator=gen)
        pos = torch.tensor([depth], dtype=torch.int32, device="cuda")
        qpos = torch.arange(depth, depth + t_blk, dtype=torch.int32,
                            device="cuda")
        off = torch.tensor([SIDE_C - 4], dtype=torch.int32, device="cuda")
        hkw = dict(heads=heads, kv_heads=kvh)
        pairs = t_blk * depth + t_blk * (t_blk + 1) // 2
        cases = [
            ("flash_decode",
             lambda: fd.flash_decode_gqa(q, k[0], v[0], pos, ks[0], vs[0],
                                         live=depth + 1),
             lambda: fd.flash_decode_plain(q, k[0], v[0], pos, ks[0], vs[0],
                                           live=depth + 1),
             attn_bound_ms(1, depth + 1, depth + 1, **hkw)),
            ("flash_prefill",
             lambda: fd.flash_prefill_gqa(qp, k[0], v[0], qpos, ks[0], vs[0],
                                          live=depth + t_blk),
             lambda: fd.flash_prefill_plain(qp, k[0], v[0], qpos, ks[0],
                                            vs[0], live=depth + t_blk),
             attn_bound_ms(t_blk, depth + t_blk, pairs, tf32_mmas=2, **hkw)),
            ("flash_decode_two_segment",
             lambda: fd.flash_decode_gqa_two_segment(
                 q, k[0], v[0], sk[0], sv[0], pos, off, ks[0], vs[0], sks[0],
                 svs[0], live=depth),
             lambda: fd.flash_decode_two_segment_plain(
                 q, k[0], v[0], sk[0], sv[0], pos, off, ks[0], vs[0], sks[0],
                 svs[0], live=depth),
             attn_bound_ms(1, depth + SIDE_C - 3, depth + SIDE_C - 3,
                           **hkw))]
        for kind, kernel, plain, (bnd, by) in cases:
            label = f"{kind} {heads}/{kvh} heads"
            diff = hold(label, kernel, plain, exact=False, tol=2e-5)
            row = dict(kernel=kind, heads=heads, kv_heads=kvh, depth=depth,
                       max_abs_diff=diff,
                       kernel_ms=device_ms(torch, lambda i: kernel(),
                                           reps=10),
                       bound_ms=bnd, bound_by=by)
            rows.append(row)
            log("shard " + json.dumps(row))
        del k, v, ks, vs, sk, sv, sks, svs
        B, bucket = BATCHED_CASES[0]
        k, v, ks, vs = cache(B, bucket)
        qb = torch.randn(B, heads, FLASH_D, device="cuda", generator=gen)
        lim_host = [0] + [int(x) for x in torch.linspace(
            1, bucket, B - 1).round().tolist()]
        lim = torch.tensor(lim_host, dtype=torch.int32, device="cuda")

        def kernel():
            return bd.batched_decode_partial(qb, k, v, 0, lim, ks, vs,
                                             bucket=bucket, fast=True)

        got = kernel()
        want = bd.batched_decode_plain(qb, k, v, 0, lim, ks, vs,
                                       bucket=bucket, fast=True)
        mag = bd.batched_decode_magnitude(qb, k, v, 0, lim, ks, vs,
                                          bucket=bucket)
        over = partials_over(got, want, value_tol(want[0], mag, True))
        if max(used for _, used in over.values()) > 1.0:
            fail(f"shard batched_decode {heads}/{kvh} heads: {over}")
        read = sum(lim_host)
        bnd, by = attn_bound_ms(B, read, read, True, B * heads * (FLASH_D + 2),
                                **hkw)
        row = dict(kernel="batched_decode_partial", heads=heads,
                   kv_heads=kvh, B=B, bucket=bucket,
                   max_abs_diff=max(dd for dd, _ in over.values()),
                   kernel_ms=device_ms(torch, lambda i: kernel(), reps=10),
                   bound_ms=bnd, bound_by=by)
        rows.append(row)
        log("shard " + json.dumps(row))
        del k, v, ks, vs
        torch.cuda.empty_cache()
    for preset in SHARD_PRESETS:
        for kind in ("q8q8", "fast", "int8", "fused_exact"):
            step = {k: sum(r[k] * (1 if r["matrix"] == "classifier" else
                                   (L if preset == "qwen3-0.6b" else L4B))
                           for r in rows if r.get("preset") == preset
                           and r["kernel"] == kind and r["b"] == 1)
                    for k in ("kernel_ms", "bound_ms")}
            log("shard step " + json.dumps(dict(preset=preset, tp=TP,
                                                kernel=kind, b=1, **step)))
    log(f"shard kernels: every matmul bit-equal to its plain version at the "
        f"tp = {TP} shard shapes, the attention kernels within their "
        f"tolerances, in {time.perf_counter() - t0:.1f} s")
    return rows


# deepseek-r1-qwen3-8b (PRESETS): dim 4096, hidden 12288, 36 layers, 32/8
# heads of 128, vocab 151936, an untied classifier
L8B = 36
MATRICES_8B = {        # name: (n = in, d = out)
    "wqkv": (4096, 6144),
    "wo": (4096, 4096),
    "w13": (4096, 24576),
    "w2": (12288, 4096),
    "classifier": (4096, 151936),
}
BATCHES_8B = (1, 512)  # decode, a prefill block


# Qwen3-30B-A3B's expert layer (HF config.json): 128 SwiGLU experts of 768
# over dim 2048, top 8, Q8_0 groups of 64; 64 rows (a decode step at 64
# slots) and 1024 (a prefill block)
MOE_E, MOE_D, MOE_F, MOE_K, MOE_G = 128, 2048, 768, 8, 64
MOE_ROWS = (64, 1024)


def moe_bounds_ms(N, reached):
    """Each expert-layer kernel's bound at N rows with `reached` experts
    routed to, ms: route, index and combine their bytes over the memory
    rate; the grouped w13 and w2 the larger of the reached experts' weight
    bytes over the memory rate and the pairs' fp32 FMAs over the fp32 pipe
    (PERF.md rows E1-E5)."""
    E, D, F, K, G = MOE_E, MOE_D, MOE_F, MOE_K, MOE_G
    wbytes = lambda rows, cols: rows * cols + 4 * rows * (cols // G)  # noqa
    mem = lambda b: 1e3 * b / HBM_BYTES_PER_S                         # noqa
    fma = lambda f: 1e3 * f / FP32_PIPE_OPS_PER_S                     # noqa
    return {
        "route": mem(wbytes(E, D) + N * (4 * D + 2 * D + 8 * K)),
        "index": mem(4 * N * K * 2 + 4 * E),
        "w13": max(mem(reached * wbytes(2 * F, D)), fma(N * K * 2 * F * D)),
        "w2": max(mem(reached * wbytes(D, F)), fma(N * K * D * F)),
        "combine": mem(4 * N * K * D + 4 * N * K + 4 * N * D)}


def moe_report(moe_rows):
    """The kernels line's entries of the expert layer (no TPU kernel: the
    JAX package has none): ms at 64 rows (a 64-slot decode step's layer)
    and at 1024, each beside its bound and library time."""
    out = []
    for name in ("route", "index", "w13", "w2", "combine"):
        by = {r["rows"]: r for r in moe_rows if r["kernel"] == name}
        out.append({
            "name": f"moe_{name}", "replaces": None, "max_abs_err": 0,
            "ms": by[64]["kernel_ms"], "bound_ms": by[64]["bound_ms"],
            "library_ms": by[64]["library_ms"],
            "ms_1024": by[1024]["kernel_ms"],
            "bound_ms_1024": by[1024]["bound_ms"],
            "library_ms_1024": by[1024]["library_ms"]})
    return out


def phase_moe_kernels(torch):
    """The sparse expert layer's five kernels (ops/cuda/moe.py) at
    Qwen3-30B-A3B's widths, 64 and 1024 rows: each bit for bit against
    its plain twin (route, index, the grouped w13 with its swiglu, the
    grouped w2, combine), and timed (CUDA events behind a spin) beside its
    bound and a library yardstick (the bf16-dequantized experts through
    torch._grouped_mm, else F.linear an expert). Then the model's own
    path: a 64-slot decode step of a 2-layer qwen3-30b-a3b at its widths
    launches five expert-layer kernels a layer (moe.LAUNCHES); and the
    layer's row bits are the same alone as among 64 or 1024 rows. Returns
    the rows."""
    import dataclasses

    import torch.nn.functional as F

    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.synthetic import synthetic_weights
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.ops.cuda import moe
    from qwen3_tpu_torch.ops.quant_matmul import dequant_weights_bf16
    from qwen3_tpu_torch.runtime.kvcache import make_side

    t0 = time.perf_counter()
    E, D, Fw, K, G = MOE_E, MOE_D, MOE_F, MOE_K, MOE_G
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)

    def q8(shape, scale=0.02):
        q = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda",
                          generator=gen)
        s = scale / 127 * (0.5 + torch.rand(shape[:-1] + (shape[-1] // G,),
                                            device="cuda", generator=gen))
        return q, s

    wr_q, wr_s = q8((E, D), 0.2)
    w13_q, w13_s = q8((E, 2 * Fw, D))
    w2_q, w2_s = q8((E, D, Fw))
    w13_b = dequant_weights_bf16(w13_q, w13_s, G)     # [E, D, 2 F]
    w2_b = dequant_weights_bf16(w2_q, w2_s, G)        # [E, F, D]
    rows = []
    for N in MOE_ROWS:
        h = torch.randn(N, D, device="cuda", generator=gen)
        ids, w, hb = moe.route(h, wr_q, wr_s, K, G)
        lst, cnt = moe.index(ids, E)
        act = moe.experts(hb, lst, cnt, w13_q, w13_s, G, K, True, N * K)
        y = moe.experts(act, lst, cnt, w2_q, w2_s, G, 1, False, N * K)
        out = moe.combine(y, w)
        torch.cuda.synchronize()
        want = moe.route_plain(h, wr_q, wr_s, K, G)
        pl, pc = moe.index_plain(ids, E)
        got_plain = (
            ("route", (ids, w, hb), want),
            ("index", (cnt,) + tuple(lst[e, :c] for e, c in
                                     enumerate(cnt.tolist())),
             (pc,) + tuple(pl[e, :c] for e, c in enumerate(pc.tolist()))),
            ("w13", (act,), (moe.experts_plain(hb, lst, cnt, w13_q, w13_s, G,
                                               K, True),)),
            ("w2", (y,), (moe.experts_plain(act, lst, cnt, w2_q, w2_s, G, 1,
                                            False),)),
            ("combine", (out,), (moe.combine_plain(y, w),)))
        for name, got, plain in got_plain:
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                fail(f"moe {name} at {N} rows: kernel != plain")
        for r in (0, 37, N - 1):   # a row's bits alone as among the N
            one = moe.expert_layer(h[r:r + 1].contiguous(), wr_q, wr_s, w13_q,
                                   w13_s, w2_q, w2_s, K, G)
            if not torch.equal(one, out[r:r + 1]):
                fail(f"moe layer row {r} alone != among {N} rows")
        counts = cnt.tolist()
        reached = sum(c > 0 for c in counts)
        offs = torch.tensor(counts, device="cuda").cumsum(0).to(torch.int32)
        order = torch.cat([lst[e, :c] for e, c in enumerate(counts)]).long()
        xg, ag = hb[order // K].contiguous(), act[order].contiguous()

        def grouped(a, b):
            try:
                torch._grouped_mm(a, b, offs=offs)
                return lambda i: torch._grouped_mm(a, b, offs=offs), \
                    "torch._grouped_mm"
            except (AttributeError, RuntimeError, TypeError):
                ends = offs.tolist()
                return (lambda i: [F.linear(a[o - c:o], b[e].T) for e, (c, o)
                                   in enumerate(zip(counts, ends)) if c],
                        "F.linear an expert")

        lib13, name13 = grouped(xg, w13_b)
        lib2, name2 = grouped(ag, w2_b)
        wf = (wr_q.float().reshape(E, -1, G) * wr_s[..., None]).reshape(E, D)
        libs = {
            "route": (lambda i: torch.topk(torch.softmax(h @ wf.T, -1), K, -1),
                      "f32 matmul, softmax, topk"),
            "index": (lambda i: torch.sort(ids.flatten(), stable=True),
                      "torch.sort"),
            "w13": (lib13, name13), "w2": (lib2, name2),
            "combine": (lambda i: (w[..., None] * y.view(N, K, D)).sum(1),
                        "(w y).sum")}
        kernels = {
            "route": lambda i: moe.route(h, wr_q, wr_s, K, G),
            "index": lambda i: moe.index(ids, E),
            "w13": lambda i: moe.experts(hb, lst, cnt, w13_q, w13_s, G, K,
                                         True, N * K),
            "w2": lambda i: moe.experts(act, lst, cnt, w2_q, w2_s, G, 1,
                                        False, N * K),
            "combine": lambda i: moe.combine(y, w)}
        bounds = moe_bounds_ms(N, reached)
        for name, fn in kernels.items():
            lib, lib_name = libs[name]
            row = dict(kernel=name, rows=N, experts_reached=reached,
                       kernel_ms=device_ms(torch, fn, reps=10),
                       bound_ms=bounds[name],
                       library_ms=device_ms(torch, lib, reps=10),
                       library=lib_name)
            rows.append(row)
            log(f"moe {name} rows={N}: {row['kernel_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ({row['kernel_ms'] / row['bound_ms']:.2f}x), "
                f"{lib_name} {row['library_ms']:.4f} ms; bit-equal to plain")
        del h, ids, w, hb, lst, cnt, act, y, out, xg, ag
    del w13_b, w2_b
    layer = {r["kernel"]: r for r in rows if r["rows"] == 64}
    log(f"moe layer at 64 rows: {sum(r['kernel_ms'] for r in layer.values()):.4f}"
        f" ms against {sum(r['bound_ms'] for r in layer.values()):.4f} bound")

    # the model's path: a 64-slot serving decode step, 2 layers at the
    # 30B's widths, a small vocabulary
    cfg = dataclasses.replace(PRESETS["qwen3-30b-a3b"], n_layers=2,
                              vocab_size=4096, seq_len=256)
    params = model.init_params(synthetic_weights(cfg, seed=5, scale=0.1),
                               mode="pallas-fast", max_seq_len=256,
                               device="cuda")
    B, pos0 = 64, 40
    k, v = model.init_kv_cache(cfg, B, 256, "int8", "cuda")
    toks = torch.randint(0, cfg.vocab_size, (B,), device="cuda",
                         generator=gen)
    base = torch.full((B,), pos0, dtype=torch.int64, device="cuda")
    sk, sv = make_side(k, 8), make_side(v, 8)
    step = lambda t, kk, vv, s: model.decode_forward(  # noqa: E731
        params, cfg, t, kk, vv, base, mode="pallas-fast", attn="fused",
        side=s, live=pos0, attn_bucket=256)
    step(toks, k, v, (sk, sv, base, 0))
    torch.cuda.synchronize()
    moe.reset_launches()
    logits = step(toks, k, v, (sk, sv, base, 0))
    torch.cuda.synchronize()
    if moe.LAUNCHES != {key: cfg.n_layers for key in moe.LAUNCHES}:
        fail(f"moe launches of a 2-layer decode step: {moe.LAUNCHES}, not "
             f"5 a layer")
    log(f"moe decode step (2 layers, 64 slots): launches {moe.LAUNCHES}; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, k, v, sk, sv, logits
    torch.cuda.empty_cache()
    return rows


def phase_8b_kernels(torch):
    """Every matmul kernel the 8B's paths can run, at its widths, b in
    BATCHES_8B, bit for bit against its plain version: the Q8_0 x Q8_0 GEMV
    and tile path (rows 1, 1b, 2) and the fused kernel exact with each
    matrix's prologue (11) of mode pallas, and the pallas-fast kernels
    (6-7). The layer matrices are whole [36, d, n] stacks and the kernels
    read the last layer, whose offset lies past 2^31 values in w13 and w2;
    w2 contracts over 12288 (192 groups, 24 k-tiles of 8). Each shape's
    time (CUDA events, weights in L2 after the first of 10 runs) beside its
    bound, and their sums over one decoded token (b = 1: 4 x 36 layer
    matmuls and the classifier). Returns the rows."""
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.norms import rms_inv
    from qwen3_tpu_torch.ops.q8 import quantize_act

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    rows = []
    for name, (n, d) in MATRICES_8B.items():
        stacked = name != "classifier"
        lead = (L8B,) if stacked else ()
        w_q = torch.randint(-127, 128, lead + (d, n), dtype=torch.int8,
                            device="cuda", generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(lead + (d, n // G),
                                             device="cuda", generator=gen))
        last = L8B - 1
        wl, sl = (w_q[last], w_s[last]) if stacked else (w_q, w_s)
        prologue = FUSED_PROLOGUES[name]
        width = 2 * n if prologue == "swiglu" else n
        x_all = torch.randn(max(BATCHES_8B), width, device="cuda",
                            generator=gen)
        nw = 1 + 0.1 * torch.randn(n, device="cuda", generator=gen)
        for b in BATCHES_8B:
            xr = x_all[:b].contiguous()
            x = xr[:, :n].contiguous()
            xq, xs = quantize_act(x, G)
            xb = x.to(torch.bfloat16)
            inv = rms_inv(xr) if prologue == "norm" else None
            if stacked:
                q8q8 = lambda: qm.q8_q8_matmul_stacked(          # noqa: E731
                    xq, xs, w_q, w_s, last, G)
                fast = lambda: qm.q8_matmul_stacked_fast(        # noqa: E731
                    xb, w_q, w_s, last, G)
            else:
                q8q8 = lambda: qm.q8_q8_matmul_tiled(            # noqa: E731
                    xq, xs, w_q, w_s, G)
                fast = lambda: qm.q8_matmul_tiled_fast(          # noqa: E731
                    xb, w_q, w_s, G)
            cases = (
                ("q8q8", q8q8, lambda: qm.q8q8_matmul_plain(
                    xq, xs, wl, sl, G), bound_ms(b, n, d)),
                ("fast", fast, lambda: qm.q8_fast_matmul_plain(
                    xb, wl, sl, G), fast_bound_ms(b, n, d)),
                ("fused_exact", lambda: qm.q8_matmul_fused(
                    xr, wl, sl, G, inv, nw, prologue=prologue, exact=True),
                 lambda: qm.q8_fused_matmul_plain(
                     xr, wl, sl, G, inv, nw, prologue=prologue, exact=True),
                 fused_bound_ms(b, n, d, prologue, True)))
            for kind, kernel, plain, (bnd, by) in cases:
                label = f"8b {name} {kind} b={b} n={n} d={d}"
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"{label}: non-finite kernel output")
                diff = (got - want).abs().max().item()
                if not torch.equal(got, want):
                    fail(f"{label}: kernel != plain (max_abs_diff "
                         f"{diff:.3e})")
                del got, want
                row = dict(matrix=name, kernel=kind, b=b, n=n, d=d,
                           layer=last if stacked else None,
                           groups_per_tile=qm.groups_per_tile(n, G),
                           max_abs_diff=diff,
                           kernel_ms=device_ms(torch, lambda i: kernel(),
                                               reps=10),
                           bound_ms=bnd, bound_by=by)
                if kind == "q8q8" and b > 1:
                    shape, splits = qm.plan_q8q8(b, n, d, G)
                    row.update(tile_rows=qm.TILE_ROWS[shape],
                               k_splits=splits)
                rows.append(row)
                log("8b kernel " + json.dumps(row))
        del w_q, w_s, wl, sl
        torch.cuda.empty_cache()
    for kind in ("q8q8", "fast", "fused_exact"):
        token = {k: sum(r[k] * (1 if r["matrix"] == "classifier" else L8B)
                        for r in rows if r["kernel"] == kind and r["b"] == 1)
                 for k in ("kernel_ms", "bound_ms")}
        log("8b token " + json.dumps(dict(kernel=kind, b=1, **token)))
    log(f"8b kernels: every matmul bit-equal to its plain version at the "
        f"8B's widths, in {time.perf_counter() - t0:.1f} s")
    return rows


def prefill_logits(torch, params, cfg, mode, ids, mesh):
    """The last prompt position's logits after the prompt's prefill on the
    CLI's block plan (chunk 64) in a 4096-row int8 cache, through the tp
    forward on `mesh` (tp = 1: the plain forward); and the first block's
    first reduction (layer 0's wo output, summed over the ranks at tp > 1,
    models.qwen3._reduce)."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.parallel.shard_layout import local_config
    from qwen3_tpu_torch.parallel.tp import make_tp_forward
    from qwen3_tpu_torch.runtime.decode_loop import prefill_blocks

    dev = params["emb_q"].device
    k, v = model.init_kv_cache(local_config(cfg, mesh.tp), 1, 4096, "int8",
                               dev)
    fwd = make_tp_forward(mesh, cfg, mode=mode)
    first = []
    orig = model._reduce

    def spy(group, y):
        out = orig(group, y)
        if not first:
            first.append(out.clone())
        return out

    model._reduce = spy
    try:
        for off, block, n_valid in prefill_blocks(ids, 0, 64, 4096):
            lg, k, v = fwd(params, torch.tensor([block], device=dev), k, v,
                           off, n_valid - 1)
    finally:
        model._reduce = orig
    return lg[0, 0], first[0]


def rank_prefill_logits(rank, path, ids, out):
    """(b) on a tp rank: prefill_logits in modes pallas and pallas-fast from
    this rank's shard of the checkpoint (load_params(tp=, rank=)); every
    rank's must be equal; rank 0 saves them to `out`."""
    import torch

    from qwen3_tpu_torch.models.qwen3 import load_params
    from qwen3_tpu_torch.parallel import launch
    from qwen3_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(dp=1, tp=TP, device="cuda")
    got = {}
    for mode in ("pallas", "pallas-fast"):
        cfg, p = load_params(path, mode, max_seq_len=4096,
                             device=mesh.device, tp=TP, rank=mesh.tp_idx)
        got[mode] = [t.cpu() for t in prefill_logits(
            torch, p, cfg.with_seq_len(4096), mode, ids, mesh)]
        del p
    if not launch.ranks_agree({m: [t.numpy().tobytes() for t in ts]
                               for m, ts in got.items()}):
        raise RuntimeError("the tp ranks computed different logits")
    if rank == 0:
        torch.save(got, out)
    return 0


def rank_fused_4b_tp(rank, out, workdir):
    """(c) on a tp rank: qwen3-4b's parameters made on the card from seed 0
    (io/device_synth.py, the whole model, as phase 4e), this rank's shard
    cut by parallel/tp.py::tp_shard_params and the rest freed; the fused
    chunk on the mesh with bench.py's headline settings (pallas, a
    1024-row bf16 cache, greedy from token 7, chunks of 32): one warm
    chunk, then TP_4B_TOKENS tokens timed, each step's launches checked (4
    x 36 + 1 matmuls and norms; 2 x 36 + 1 collectives); then
    chunk_profile's three chunks on every rank, profiled on rank 0. The
    ranks' ids must be equal; rank 0 writes its numbers to `out`."""
    import torch

    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.device_synth import synth_device_params
    from qwen3_tpu_torch.models.qwen3 import init_kv_cache
    from qwen3_tpu_torch.parallel import comm, launch
    from qwen3_tpu_torch.parallel.sharding import make_mesh
    from qwen3_tpu_torch.parallel.shard_layout import (
        local_config,
        tp_shard_params,
    )
    from qwen3_tpu_torch.parallel.tp import make_tp_decode_chunk
    from qwen3_tpu_torch.runtime.decode_loop import chunk_steps
    from qwen3_tpu_torch.runtime.xorshift import seed_to_device

    cfg, b = PRESETS["qwen3-4b"], BENCH_4B
    mesh = make_mesh(dp=1, tp=TP, device="cuda")
    dev = mesh.device
    t0 = time.perf_counter()
    full = synth_device_params(cfg, b["ctx"], seed=0, device=dev)
    params = tp_shard_params(full, cfg, TP, mesh.tp_idx)
    del full
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    shard_gb = sum(t.numel() * t.element_size()
                   for t in params.values()) / 1e9
    load_s = time.perf_counter() - t0
    rows = b["ctx"]
    k, v = init_kv_cache(local_config(cfg, TP), 1, rows, "bfloat16", dev)
    hi, lo = seed_to_device(3, dev)
    tok = torch.full((1,), 7, dtype=torch.int64, device=dev)
    fn = make_tp_decode_chunk(
        mesh, cfg, mode="pallas", chunk=b["chunk"], temperature=1e-6,
        top_p=0.9, greedy=True, bos=cfg.vocab_size - 1,
        eos=cfg.vocab_size - 2, top_k=64, attn="dense")
    pos, ids = 0, []

    def chunk():
        nonlocal k, v, tok, hi, lo, pos
        packed, k, v, tok, _, hi, lo = fn(params, k, v, tok, pos, rows, hi,
                                          lo)
        row = packed.cpu()
        n = int(row[-2])
        ids.extend(row[:n].tolist())
        pos = min(pos + n, rows)
        return row

    chunk()                                               # warm
    # the timed chunks' launches and collectives, as differences: rank 0
    # runs in the smoke's own process, whose counts the tp path reads
    before, coll0 = read_counts(), dict(comm.COUNTS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = emitted = 0
    while emitted < TP_4B_TOKENS:
        steps += chunk_steps(pos, rows, b["chunk"])
        row = chunk()
        emitted += int(row[-2])
        if bool(row[-1]) or int(row[-2]) == 0:
            break
    dt = time.perf_counter() - t1
    got = {k_: c - before[k_] for k_, c in read_counts().items()
           if c != before[k_]}
    coll = {k_: c - coll0[k_] for k_, c in comm.COUNTS.items()}
    want = {k_: n for k_, n in dict(
        stacked=4 * L4B * steps, tiled=steps,
        **norm_launches(steps, 0, L4B)).items() if n}
    if got != want or coll["calls"] != (2 * L4B + 1) * steps:
        raise RuntimeError(f"qwen3-4b tp: launches {got} and {coll['calls']} "
                           f"collectives for {steps} steps; want {want} and "
                           f"{(2 * L4B + 1) * steps}")
    prof = None
    if rank == 0:
        prof = chunk_profile(torch, f"qwen3-4b tp={TP} fused chunk, ctx "
                             f"{rows}", chunk, b["chunk"],
                             str(Path(workdir) / "chunk4b_tp"))
    else:
        for _ in range(3):                 # chunk_profile's three chunks
            chunk()
    if not launch.ranks_agree(ids):
        raise RuntimeError("the tp ranks decoded different ids")
    if rank == 0:
        Path(out).write_text(json.dumps(dict(
            tp=TP, shard_gb=shard_gb, load_s=load_s, tokens=emitted,
            steps=steps, seconds=dt, tok_s=emitted / dt,
            launches_per_step={k_: c / steps for k_, c in got.items()},
            collectives_per_step=coll["calls"] / steps,
            collective_bytes_per_step=coll["bytes"] / steps, profile=prof,
            first_ids=ids[:16])))
    return 0


def sampler_batch_check(torch, vocab=151936, seed=0):
    """Whether a row's sampled token and sums follow its batch on the card:
    sample_tokens (seeded at t 0.8, top-p 0.9, top-k hint 64, as serve.py)
    over 8 rows against the same first 4 rows alone, on 200 draws of flat
    random logits, and over 64 rows against each of rows 0, 31 and 63
    alone, on 10 draws; the softmax sums (row_sum) and the prefix sums of
    the sorted probabilities (cumsum_last) compared the same way. Any
    difference fails the run: a dp rank samples its own share of the slots,
    and a serving slot's batch-mates come and go."""
    from qwen3_tpu_torch.runtime.sampler import (
        cumsum_last,
        row_sum,
        sample_tokens,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    diff = dict(tokens_differ=0, softmax_sums_differ=0,
                prefix_sums_differ=0)

    def sums(lg):
        x = lg / 0.8
        e = torch.exp(x - x.amax(-1, keepdim=True))
        s = row_sum(e)
        sp = torch.sort(e / s[:, None], dim=-1, descending=True,
                        stable=True)[0]
        return s, cumsum_last(sp)

    def compare(lg, coin, pick):
        wide_t = sample_tokens(lg, coin, 0.8, 0.9, top_k_hint=SAMPLER_K)
        wide_s, wide_c = sums(lg)
        sub = lg[pick].contiguous()
        t = sample_tokens(sub, coin[pick].contiguous(), 0.8, 0.9,
                          top_k_hint=SAMPLER_K)
        s, c = sums(sub)
        diff["tokens_differ"] += int((wide_t[pick] != t).sum())
        diff["softmax_sums_differ"] += int((wide_s[pick] != s).sum())
        diff["prefix_sums_differ"] += int(
            (wide_c[pick] != c).any(-1).sum())

    for _ in range(200):
        lg = 2.0 * torch.randn(8, vocab, device="cuda", generator=gen)
        compare(lg, torch.rand(8, device="cuda", generator=gen),
                slice(0, 4))
    for _ in range(10):
        lg = 2.0 * torch.randn(64, vocab, device="cuda", generator=gen)
        coin = torch.rand(64, device="cuda", generator=gen)
        for r in (0, 31, 63):
            compare(lg, coin, slice(r, r + 1))
    out = dict(draws_8_vs_4=200, rows_8_vs_4=800, draws_64_vs_1=10,
               rows_64_vs_1=30, **diff)
    log("sampler batch " + json.dumps(out))
    if any(diff.values()):
        fail(f"sampler batch: a row's token or sums follow its batch: {out}")
    return out


def by_id_diff(recs, want):
    """The ids of the requests whose record differs from want's."""
    mine = {r["id"]: r for r in untimed(recs)}
    return [w["id"] for w in untimed(want) if mine.get(w["id"]) != w]


def first_difference(a, b):
    """The first index where two sequences differ (None if one is a prefix
    of the other)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_tp_paths(torch, path: str, workdir: Path, card: str):
    """The tensor- and data-parallel paths on this host's card(s), counted
    as one path (launch counts set to 0 before and read after; the counts
    are rank 0's, which runs in this process): (b) the CLI at --tp 2 with
    its defaults on the 826-token prompt at -c 4096, greedy and seeded
    twice (the ranks agree, checked by the CLI; the seeded bytes repeat),
    the first byte where greedy stdout leaves tp = 1's (not gated), and the
    prefill's last logits and layer 0's output at tp = 2 against tp = 1 in
    modes pallas and pallas-fast (TP_LOGIT_TOL, TP_LAYER_TOL); (c) the
    fused chunk at qwen3-4b's full width at tp = 2 (rank_fused_4b_tp); (d)
    serve.py at --tp 2 (B = 8, -c 1024, greedy; the requests whose stream
    leaves tp = 1's, not gated) and at --dp 2, greedy and seeded, every
    record equal to the single-rank server's (gated: a rank samples its own
    share of the rows, and the sampler's fixed-order sums do not follow
    them, see sampler_batch_check). Then,
    not counted (processes of their own): (e) the CLI through
    --coordinator in two processes (process 0 prints the spawned --tp 2
    run's bytes, process 1 nothing; chat returns rc 1). The backend is the rule's (checked on the [Mesh] line): on a host
    with one card the ranks share it over gloo, and no multi-card scaling
    shows; with a card a rank every run above is NCCL's. Returns (counts,
    results)."""
    from qwen3_tpu_torch.models.qwen3 import load_params
    from qwen3_tpu_torch.parallel import comm, launch
    from qwen3_tpu_torch.parallel.sharding import make_mesh
    from qwen3_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    base = [path, "--device", "cuda"]
    greedy = base + ["-m", "completion", "-i", PROMPT, "-t", "0", "-s", "42",
                     "-c", "4096", "--max-tokens", str(TP_TOKENS)]
    seeded = base + ["-m", "completion", "-i", PROMPT, "-t", "0.8", "-p",
                     "0.9", "-s", "7", "-c", "4096", "--max-tokens",
                     str(TP_TOKENS)]
    serve_greedy = base + ["-t", "0", "-s", "42", "--max-tokens",
                           str(TP_SERVE_TOKENS)]
    serve_seeded = base + ["-t", "0.8", "-p", "0.9", "-s", "7",
                           "--max-tokens", str(TP_SERVE_TOKENS)]
    prompts = serve_prompts(16, 5, 30, 1)
    ids = Tokenizer.from_file(path).encode(PROMPT)

    # tp = 1 references, outside the counted path
    one_out, one_err = run_cli(greedy)
    one_greedy, one_serr = run_serve(serve_greedy, prompts, workdir)
    one_seeded, _ = run_serve(serve_seeded, prompts, workdir)
    log("tp 1 references: cli " + str(re.findall(
        r"\[(pp|tg|t/ms|tok/s) ([0-9.]+)(?:ms)?\]", one_err)) + "; serve "
        + str(re.findall(r"\(([0-9.]+) tok/s aggregate\)", one_serr)))
    want = {}
    for mode in ("pallas", "pallas-fast"):
        cfg, p = load_params(path, mode, max_seq_len=4096, device="cuda")
        want[mode] = [t.cpu() for t in prefill_logits(
            torch, p, cfg.with_seq_len(4096), mode, ids,
            make_mesh(1, 1, device="cuda"))]
        del p
    torch.cuda.empty_cache()

    reset_counts()
    comm.reset_counts()
    res = {}
    tp_flag = ["--tp", str(TP)]
    out2, err2, res["cli_greedy"] = checked_run(
        torch, f"cli --tp {TP} greedy", greedy + tp_flag)
    mesh_line = next((ln for ln in err2.splitlines()
                      if ln.startswith("[Mesh]")), "")
    # the rule: NCCL with a card a rank (rank r on card r % the cards)
    backend = "nccl" if torch.cuda.device_count() >= TP else "gloo"
    if f"backend={backend}" not in mesh_line:
        fail(f"cli --tp: the [Mesh] line {mesh_line!r} does not show the "
             f"rule's backend {backend}")
    log(f"cli --tp {TP}: {mesh_line}")
    res["greedy_first_difference"] = first_difference(out2, one_out)
    log(f"cli --tp {TP} greedy against --tp 1: first differing stdout byte "
        f"{res['greedy_first_difference']} of {len(out2)} (not gated: the "
        f"wo/w2 sums run in two chains)")
    s1, _, res["cli_seeded_1"] = checked_run(
        torch, f"cli --tp {TP} seeded run 1", seeded + tp_flag)
    s2, _, res["cli_seeded_2"] = checked_run(
        torch, f"cli --tp {TP} seeded run 2", seeded + tp_flag)
    if s1 != s2:
        fail(f"cli --tp {TP} seeded: the two runs printed different bytes")
    rc = launch.run_ranks(rank_prefill_logits, TP,
                          (path, ids, str(workdir / "tp_logits.pt")),
                          device="cuda")
    if rc != 0:
        fail(f"tp prefill logits: rc {rc}")
    got = torch.load(workdir / "tp_logits.pt")
    for mode in ("pallas", "pallas-fast"):
        (lg2, x2), (lg1, x1) = got[mode], want[mode]
        if not (torch.isfinite(lg2).all() and lg2.shape == lg1.shape):
            fail(f"tp logits {mode}: {lg2.shape}, finite "
                 f"{bool(torch.isfinite(lg2).all())}")
        rel = ((lg2 - lg1).abs().max() / lg1.abs().max()).item()
        rel0 = ((x2 - x1).abs().max() / x1.abs().max()).item()
        same = int(lg2.argmax()) == int(lg1.argmax())
        res[f"logits_{mode}"] = dict(rel_diff=rel, layer0_rel_diff=rel0,
                                     argmax_equal=same)
        log(f"tp {TP} against tp 1, {mode}: the prefill's last logits "
            f"max|diff| / max|logits| {rel:.3e} (gate {TP_LOGIT_TOL}), "
            f"argmax equal {same} (not gated); layer 0's wo output "
            f"{rel0:.3e} (gate {TP_LAYER_TOL})")
        if rel > TP_LOGIT_TOL or rel0 > TP_LAYER_TOL:
            fail(f"tp logits {mode} beyond their tolerances")
    rc = launch.run_ranks(rank_fused_4b_tp, TP,
                          (str(workdir / "tp_4b.json"), str(workdir)),
                          device="cuda")
    if rc != 0:
        fail(f"qwen3-4b tp chunk: rc {rc}")
    res["fused_4b"] = json.loads((workdir / "tp_4b.json").read_text())
    log(f"qwen3-4b tp={TP} " + json.dumps(res["fused_4b"]) + f" ({card})")
    recs, res["serve_tp"] = checked_serve(
        torch, f"serve --tp {TP} (B = 8, -c 1024, greedy)",
        serve_greedy + tp_flag, prompts, workdir, "fused", TP_SERVE_TOKENS)
    diverged = by_id_diff(recs, one_greedy)
    res["serve_tp_diverged"] = diverged
    log(f"serve --tp {TP} against --tp 1: requests whose stream differs "
        f"{diverged} of {len(prompts)} (not gated)")
    recs, res["serve_dp"] = checked_serve(
        torch, "serve --dp 2 (B = 8, -c 1024, greedy)",
        serve_greedy + ["--dp", "2"], prompts, workdir, "fused",
        TP_SERVE_TOKENS)
    if untimed(recs) != untimed(one_greedy):
        fail("serve --dp 2: records differ from the single-rank server's")
    recs, res["serve_dp_seeded"] = checked_serve(
        torch, "serve --dp 2 (B = 8, -c 1024, seeded)",
        serve_seeded + ["--dp", "2"], prompts, workdir, "fused",
        TP_SERVE_TOKENS)
    diverged = by_id_diff(recs, one_seeded)
    res["serve_dp_seeded_diverged"] = diverged
    log(f"serve --dp 2 seeded against the single-rank server: requests "
        f"whose record differs {diverged} of {len(prompts)}")
    if diverged:
        fail(f"serve --dp 2 seeded: the records of requests {diverged} "
             f"differ from the single-rank server's")
    counts = read_counts()
    coll = dict(comm.COUNTS)
    log(f"tp path launches (rank 0, the runs above): {counts}; collectives "
        f"{coll}")
    if min(counts[k] for k in ("stacked", "tiled", "stacked_fast",
                               "tiled_fast", "batched_decode_partial",
                               "rmsnorm", "add_rmsnorm", "qk_norm_rope",
                               "softmax_sum", "prefix_sum")) == 0:
        fail("a kernel of the tp path was never launched")

    # (e) processes joined through --coordinator, outside the count
    port = launch.free_port()
    env = dict(os.environ, PYTHONPATH=str(HERE))
    argv = [sys.executable, "-m", "qwen3_tpu_torch.cli", *greedy, *tp_flag,
            "--coordinator", f"127.0.0.1:{port}", "--num-processes",
            str(TP)]
    procs = [subprocess.Popen(argv + ["--process-id", str(i)], cwd=HERE,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for i in range(TP)]
    outs = [p.communicate(timeout=600) for p in procs]
    for i, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"--coordinator process {i}: rc {p.returncode}\n"
                 f"{e.decode(errors='replace')[-3000:]}")
    if outs[0][0] != out2 or any(o or e for o, e in outs[1:]):
        fail("--coordinator: process 0 did not print the --tp run's bytes, "
             "or another process wrote")
    chat = subprocess.run(
        [sys.executable, "-m", "qwen3_tpu_torch.cli", path, "-m", "chat",
         *tp_flag, "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(TP), "--process-id", "0"], cwd=HERE, env=env, input=b"hi\n",
        capture_output=True, timeout=120)
    if chat.returncode != 1:
        fail(f"--coordinator chat: rc {chat.returncode}, want 1")
    log(f"--coordinator: {TP} processes printed the --tp {TP} run's bytes; "
        f"chat returned 1")
    if backend == "nccl":
        log("NCCL: the tp paths above ran over NCCL, a card a rank")
    else:
        log(f"NCCL not run: this host shows {torch.cuda.device_count()} "
            f"card, so the ranks shared it over gloo (the rule picks NCCL "
            f"only with a card a rank)")
    log(f"tp phase: {time.perf_counter() - t0:.1f} s")
    return counts, res


# -- phase 4g: deepseek-r1-qwen3-8b end to end from its .bin -------------------

E2E_8B_TOKENS = 96             # the JAX tool's default


def phase_e2e_8b(torch, workdir: Path, card: str):
    """Phase 4g, counted as a path of its own (launch counts set to 0
    before, read after): the port's tools/e2e_8b.py in this process on the
    card: deepseek-r1-qwen3-8b's .bin (8.1 GiB, seed 0, header seq_len
    32768) generated into the work directory, read back through
    io/checkpoint.py (the file's size against the header's arithmetic; the
    last layer's w2 and the classifier, past 4 GiB, against the generator's
    digests), then served by serve.py --batch 1 --qmode pallas --kv-dtype
    int8 --attn flash -c 32768 greedy (-s 3), E2E_8B_TOKENS tokens, with the
    launch-count check for 36 layers (want_launches). Logs every stage's
    time, the serving metrics and the peak device memory; deletes the .bin.
    Returns (the path's counts, the tool's record)."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.tools import e2e_8b

    t0 = time.perf_counter()
    cache = workdir / "e2e_8b"
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    argv = ["--cache-dir", str(cache), "--out", str(workdir / "e2e_8b.json"),
            "--ctx", "32768", "--max-tokens", str(E2E_8B_TOKENS),
            "--device", "cuda"]

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = e2e_8b.main(argv)
        return rc, json.loads(out.getvalue().strip().splitlines()[-1])

    reset_counts()
    try:
        (rc, res), run_info = checked(torch, "8b serve", run, layers=L8B)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    counts = read_counts()
    rb, srv = res["readback"], res["serve"]
    cfg = dataclasses.replace(PRESETS["deepseek-r1-qwen3-8b"], seq_len=32768)
    calls = run_info["calls"]
    log(f"8b: rc {rc}; generated in {res['gen_s']} s (arrays "
        f"{res.get('gen_arrays_s')} s), {res['bin_gib']} GiB; readback "
        f"{json.dumps(rb)}; serve {json.dumps({k: v for k, v in srv.items() if k not in ('stdout', 'stderr_tail')})}; "
        f"peak device memory {srv['peak_device_gb']} GB (of which "
        f"{base_gb:.3f} GB held before the phase); passes {calls}; "
        f"launches { {k: n for k, n in counts.items() if n} } ({card})")
    if rc != 0 or not res["ok"] or srv["rc"] != 0:
        fail(f"8b: the tool failed: rc {rc}\n{srv.get('stderr_tail')}")
    if res["gen_s"] is None:
        fail("8b: the .bin was not generated in this run")
    if not (rb["size_ok"] and rb["bytes"] == e2e_8b.checkpoint_bytes(cfg)
            and rb["bytes"] > 2**32):
        fail(f"8b: the .bin's size {rb['bytes']} is not the header's "
             f"{e2e_8b.checkpoint_bytes(cfg)}")
    if rb["digests_ok"] is not True:
        fail("8b: the tensors past 4 GiB differ from the generator's")
    rec = json.loads(srv["stdout"].strip().splitlines()[-1])
    if not 0 < rec["n_tokens"] <= E2E_8B_TOKENS:
        fail(f"8b: {rec['n_tokens']} tokens served")
    if rec["n_tokens"] < E2E_8B_TOKENS:
        log(f"8b: the stream stopped after {rec['n_tokens']} tokens (a "
            f"stop token)")
    if calls["mm_pallas"] != run_info["blocks"] + run_info["steps"]:
        fail(f"8b: passes {calls}: want every pass in mode pallas")
    if min(counts[k] for k in ("stacked", "tiled", "rmsnorm", "add_rmsnorm",
                               "qk_norm_rope")) == 0 or not (
            counts["flash_decode"] or counts["flash_decode_two_segment"]):
        fail("8b: a kernel of the path was never launched")
    log(f"8b: attention kernels by the counts: flash prefill "
        f"{counts['flash_prefill']} (serve.py's prefill is dense), flash "
        f"decode {counts['flash_decode']}, two-segment flash "
        f"{counts['flash_decode_two_segment']}; sampler "
        f"{counts['softmax_sum']} (greedy: argmax)")
    log(f"8b phase: {time.perf_counter() - t0:.1f} s")
    return counts, res


# -- phase 5 -------------------------------------------------------------------

class Forcing:
    """The rounding steps of a forward pass, recorded on the card and
    replayed on the CPU: in mode pallas a Q8 activation quantization (before
    each matmul), in mode pallas-fast the bf16 rounding of the activation
    (before each matmul), in mode pallas-int8 the activation quantization
    per (row, k-tile) inside each int8 matmul and the bf16 rounding of each
    dot operand of the dense attention (q, K, V and the probabilities), and
    in all an int8 KV encode. Under spy("record") each step runs and keeps
    its input, its other arguments and its outputs (on the host); under
    spy("forced") each step returns the recorded outputs, in order, and
    keeps the input it was given. The int8 kernels quantize their
    activations inside; on the card that step is recorded by quantize_act
    on the kernel's input at its k-tile, the plain op phase 3 holds the
    kernels to bit for bit."""

    def __init__(self, mode: str = "pallas"):
        from qwen3_tpu_torch.models import qwen3 as model
        from qwen3_tpu_torch.ops import attention
        from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
        from qwen3_tpu_torch.runtime import kvcache as kvc

        act = {"pallas": ("q8", model, "quantize_act"),
               "pallas-fast": ("bf16", model, "round_bf16"),
               "pallas-int8": ("q8i8", qm, "quantize_act")}[mode]
        self.sites = {act[0]: act[1:], "kv": (kvc, "quantize_heads")}
        self.kernels = {}
        if mode == "pallas-int8":
            self.sites["att"] = (attention, "dot_operand")
            self.kernels = {name: getattr(model, name) for name in (
                "q8i8_matmul_stacked", "q8i8_matmul_tiled")}
        self.rounding = {k: getattr(*w) for k, w in self.sites.items()}
        self.card_log = {k: [] for k in self.sites}
        self.card_args = {k: [] for k in self.sites}
        self.cpu_in = {k: [] for k in self.sites}

    def _record(self, kind):
        def step(x, *rest):
            out = self.rounding[kind](x, *rest)
            outs = out if isinstance(out, tuple) else (out,)
            self.card_log[kind].append((x.cpu(), [t.cpu() for t in outs]))
            self.card_args[kind].append(rest)
            return out
        return step

    def _forced(self, kind):
        def step(x, *rest):
            self.cpu_in[kind].append(x)
            outs = self.card_log[kind][len(self.cpu_in[kind]) - 1][1]
            return tuple(outs) if len(outs) > 1 else outs[0]
        return step

    def _int8_recorded(self, fn):
        from qwen3_tpu_torch.ops.cuda import q8_matmul as qm

        def call(x, *rest):
            n = x.shape[-1]
            self._record("q8i8")(x.reshape(-1, n).float(),
                                 qm.int8_tile(n, rest[-1]))
            return fn(x, *rest)
        return call

    @contextlib.contextmanager
    def spy(self, how):
        """how: None (the plain steps), "record" or "forced"."""
        from qwen3_tpu_torch.models import qwen3 as model

        for kind, (mod, name) in self.sites.items():
            setattr(mod, name, getattr(self, "_" + how)(kind) if how
                    else self.rounding[kind])
        for name, fn in self.kernels.items():
            setattr(model, name, self._int8_recorded(fn) if how == "record"
                    else fn)
        try:
            yield
        finally:
            for kind, (mod, name) in self.sites.items():
                setattr(mod, name, self.rounding[kind])
            for name, fn in self.kernels.items():
                setattr(model, name, fn)

    def check(self, torch, label, card, forced_cpu, cfg, need_gap=True,
              loose=None, every_row=False):
        """Every step's input on the CPU within 1e-5 of the card's max|.|
        (`loose`: {(kind, step): extra absolute tolerance, a number or one
        per element} for the steps that follow an op allowed more), every
        step on the CPU bit for bit
        from the card's input, the logits [rows, V] within 1e-3 *
        max|logits|, and the argmax equal at the row whose CPU top-2 gap is
        widest (which must exceed the tolerance when `need_gap`), or at
        every row (`every_row`). Returns the logits' max_abs_diff."""
        loose = loose or {}
        # per layer: 2 KV encodes, 4 attention dot operands, 4 matmul
        # inputs; and the classifier's input
        want_steps = {k: {"kv": 2, "att": 4}.get(k, 4) * cfg.n_layers
                      + (k not in ("kv", "att")) for k in self.sites}
        rel, unequal, over = {}, {}, []
        for kind in self.sites:
            rel[kind] = []
            for i, ((x, _), c) in enumerate(zip(self.card_log[kind],
                                                self.cpu_in[kind])):
                gap = (c.float() - x.float()).abs()
                d, scale = gap.max().item(), x.float().abs().max().item()
                rel[kind].append(d / scale)
                extra = loose.get((kind, i), 0.0)
                if ((gap - extra).max().item() > 1e-5 * scale):
                    over.append((kind, i, d))
            def same(x, outs, rest, kind=kind):
                out = self.rounding[kind](x, *rest)
                out = out if isinstance(out, tuple) else (out,)
                return all(map(torch.equal, out, outs))

            unequal[kind] = [i for i, ((x, outs), rest) in enumerate(zip(
                self.card_log[kind], self.card_args[kind]))
                if not same(x, outs, rest)]
        tol = 1e-3 * forced_cpu.abs().max().item()
        diff = (card - forced_cpu).abs().max().item()
        top2 = torch.topk(forced_cpu, 2, dim=-1).values
        gaps = top2[:, 0] - top2[:, 1]
        t = int(gaps.argmax())
        rows = range(card.shape[0]) if every_row else (t,)
        argmax = [(int(card[r].argmax()), int(forced_cpu[r].argmax()))
                  for r in rows]
        for kind in self.sites:
            worst = max(rel[kind])
            log(f"{label} step by step, {kind} rounding: {len(rel[kind])} "
                f"steps, CPU input vs the card's max|diff|/max|x| worst "
                f"{worst:.3e} (step {rel[kind].index(worst)}), median "
                f"{statistics.median(rel[kind]):.3e}; steps whose output on "
                f"the CPU from the card's input differs: {unequal[kind]}")
        log(f"{label} step by step: logits max_abs_diff {diff:.3e}, "
            f"tolerance {tol:.3e}; argmax (card / CPU) at rows "
            f"{list(rows)}: {argmax} (CPU top-2 gap at row {t} "
            f"{gaps[t].item():.3e})")
        if {k: len(v) for k, v in rel.items()} != want_steps:
            fail(f"{label}: rounding steps "
                 f"{({k: len(v) for k, v in rel.items()})}, want {want_steps}")
        if over:
            fail(f"{label}: an op between two rounding steps disagrees on "
                 f"the card: (kind, step, max_abs_diff) {over[:4]}")
        if any(unequal.values()):
            fail(f"{label}: a rounding step on the card differs from the "
                 f"CPU's")
        if diff > tol:
            fail(f"{label}: logits on the card disagree with the CPU plain "
                 f"path")
        if need_gap and gaps[t].item() <= tol:
            fail(f"{label}: no position's CPU top-2 gap exceeds the "
                 f"tolerance")
        if any(a != b for a, b in argmax):
            fail(f"{label}: argmax on the card differs from the CPU plain "
                 f"path")
        return diff


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
    from qwen3_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer.from_file(path).encode(PROMPT)[:64]
    forcing = Forcing()

    def logits_of(params, cfg, device, nudge=0.0, spy=None):
        if nudge:   # emb_s only: a tied classifier keeps its own reference
            params = dict(params, emb_s=torch.nextafter(
                params["emb_s"], torch.full_like(params["emb_s"], nudge)))
        k, v = model.init_kv_cache(cfg, 1, 256, "int8", device)
        toks = torch.tensor([ids], device=device)
        with forcing.spy(spy):
            logits, _, _ = model.forward(params, cfg, toks, k, v, 0,
                                         all_logits=True)
        return logits[0].float().cpu()                      # [64, V]

    cfg, params = model.load_params(path, max_seq_len=256, device="cuda")
    card = logits_of(params, cfg, "cuda", spy="record")
    card_nudged = logits_of(params, cfg, "cuda", float("inf"))[-1]
    del params
    cfg, params = model.load_params(path, max_seq_len=256, device="cpu")
    forced_cpu = logits_of(params, cfg, "cpu", spy="forced")
    free = {s: logits_of(params, cfg, "cpu", s)[-1]
            for s in (0.0, float("inf"), float("-inf"))}
    del params
    if card.shape != (64, cfg.vocab_size) or not torch.isfinite(card).all():
        fail(f"prefill logits: shape {tuple(card.shape)} or non-finite")
    diff = forcing.check(torch, "prefill block (64 tokens)", card,
                         forced_cpu, cfg)

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


def phase_plain_depth(torch, path: str):
    """The long-context path against its plain version at depth, step by
    step (see Forcing): the long prompt's first 8192 tokens prefill on the
    card (dense, 16 blocks of 512); the card's KV cache is copied to the
    CPU; then, with attn="flash" on both devices, one 64-token block at
    8192 (flash prefill) and one decode step at depth 8256 (flash decode),
    the card's rounding decisions forced on the CPU. The block is held like
    phase 5's; the single decode row has no choice of position, so its
    argmax need only agree."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime.kvcache import pad_rows
    from qwen3_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer.from_file(path).encode(LONG_PROMPT)
    start, n = FLASH_DEPTH, 64
    block, tok = ids[start:start + n], ids[start + n]
    rows = pad_rows(start + n + 1)
    t0 = time.perf_counter()
    cfg, params = model.load_params(path, max_seq_len=rows, device="cuda")
    k, v = model.init_kv_cache(cfg, 1, rows, "int8", "cuda")
    for off in range(0, start, 512):
        toks = torch.tensor([ids[off:off + 512]], device="cuda")
        _, k, v = model.forward(params, cfg, toks, k, v, off)
    k_cpu, v_cpu = (tuple(t.cpu() for t in c) for c in (k, v))
    at_block, at_step = Forcing(), Forcing()
    with at_block.spy("record"):
        card_block, k, v = model.forward(
            params, cfg, torch.tensor([block], device="cuda"), k, v, start,
            all_logits=True, attn="flash")
    with at_step.spy("record"):
        card_step, _, _ = model.decode_forward(
            params, cfg, torch.tensor([tok], device="cuda"), k, v,
            torch.tensor([start + n], device="cuda"), attn="flash")
    card_block = card_block[0].float().cpu()
    card_step = card_step.float().cpu()
    del params, k, v
    torch.cuda.empty_cache()
    cfg, params = model.load_params(path, max_seq_len=rows, device="cpu")
    with at_block.spy("forced"):
        cpu_block, k_cpu, v_cpu = model.forward(
            params, cfg, torch.tensor([block]), k_cpu, v_cpu, start,
            all_logits=True, attn="flash")
    with at_step.spy("forced"):
        cpu_step, _, _ = model.decode_forward(
            params, cfg, torch.tensor([tok]), k_cpu, v_cpu,
            torch.tensor([start + n]), attn="flash")
    del params, k_cpu, v_cpu
    for name, x in (("block", card_block), ("step", card_step)):
        if not torch.isfinite(x).all():
            fail(f"flash {name} at depth: non-finite logits on the card")
    diffs = (at_block.check(torch, f"flash prefill block ({n} tokens at "
                            f"{start})", card_block, cpu_block[0].float(),
                            cfg),
             at_step.check(torch, f"flash decode step at depth {start + n}",
                           card_step, cpu_step.float(), cfg, need_gap=False))
    log(f"flash path at depth vs the CPU plain path: "
        f"{time.perf_counter() - t0:.1f} s")
    return diffs


SERVE_LENGTHS = (9, 40, 64, 77, 100, 120, 128, 23)   # prompt tokens a slot


def phase_serving_plain(torch, path: str):
    """One batched decode step of the serving path at B = 8 on the card
    against the CPU plain path, step by step (see Forcing, mode
    pallas-fast): 8 slots prefilled on the card to the token counts in
    SERVE_LENGTHS (one [1, 128] block each, as admission runs them), the
    card's KV cache copied to the CPU, then one side-buffer decode step with
    attn="fused" on both devices, the card's bf16 activation roundings and
    int8 KV encodes forced on the CPU. The ops between the rounding steps
    are held to 1e-5 of their max, except the input of each layer's wo
    matmul, the attention output: the bf16 roundings inside the fast
    attention are not forced, and the kernel rounds its value dot's operand
    p * vs relative to other running maxima than the plain version does
    (see value_tol). So each element of that input may move 2^-8 * mag
    more, mag = sum_s p_s * |v_s * vs_s| / sum_s p_s over its main and side
    rows: the plain attention over |v| with q rounded to bf16, taken beside
    each CPU attention call. The logits are held to 1e-3 * max|logits| and
    every row's argmax must agree."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime import kvcache as kvc
    from qwen3_tpu_torch.runtime.batched import (
        bucket_sizes,
        prefill_slot_chunk,
    )
    from qwen3_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer.from_file(path).encode(PROMPT)
    B, C, rows, mode = len(SERVE_LENGTHS), SIDE_C, 1152, "pallas-fast"
    tokens = ids[200:200 + B]
    bucket = next(n for n in bucket_sizes(rows) if n >= max(SERVE_LENGTHS))
    t0 = time.perf_counter()
    cfg, params = model.load_params(path, mode=mode, max_seq_len=1024,
                                    device="cuda")
    k, v = model.init_kv_cache(cfg, B, rows, "int8", "cuda")
    for b, n in enumerate(SERVE_LENGTHS):
        _, k, v = prefill_slot_chunk(params, cfg, k, v,
                                     ids[:n] + [0] * (128 - n), b, 0, n - 1,
                                     mode=mode)
    k_cpu, v_cpu = (tuple(t.cpu() for t in c) for c in (k, v))
    forcing = Forcing(mode)

    def step(params, k, v, device):
        pos = torch.tensor(SERVE_LENGTHS, device=device)
        side = (kvc.make_side(k, C), kvc.make_side(v, C), pos, 0)
        logits, _, _ = model.decode_forward(
            params, cfg, torch.tensor(tokens, device=device), k, v, pos,
            mode=mode, attn="fused", side=side, attn_bucket=bucket)
        return logits.float().cpu()

    with forcing.spy("record"):
        card = step(params, k, v, "cuda")
    del params, k, v
    torch.cuda.empty_cache()
    cfg, params = model.load_params(path, mode=mode, max_seq_len=1024,
                                    device="cpu")
    attention, mags = model.fused_batched_attention, []

    def with_magnitude(q, k_main, v_main, k_side, v_side, *rest, **kw):
        mags.append(attention(q.to(torch.bfloat16).float(), k_main,
                              v_main.abs(), k_side, v_side.abs(), *rest,
                              **dict(kw, fast=False)))
        return attention(q, k_main, v_main, k_side, v_side, *rest, **kw)

    model.fused_batched_attention = with_magnitude
    try:
        with forcing.spy("forced"):
            cpu = step(params, k_cpu, v_cpu, "cpu")
    finally:
        model.fused_batched_attention = attention
    del params
    if len(mags) != cfg.n_layers:
        fail(f"serving step: {len(mags)} fused attention calls on the CPU, "
             f"want {cfg.n_layers}")
    wo_in = [forcing.card_log["bf16"][4 * l + 1][0] for l in range(len(mags))]
    loose = {("bf16", 4 * l + 1): 2.0 ** -8 * mag.reshape(x.shape)
             for l, (mag, x) in enumerate(zip(mags, wo_in))}
    if card.shape != (B, cfg.vocab_size) or not torch.isfinite(card).all():
        fail(f"serving step logits: shape {tuple(card.shape)} or non-finite")
    diff = forcing.check(torch, f"serving decode step (B={B}, fused, "
                         f"pallas-fast)", card, cpu, cfg, need_gap=False,
                         loose=loose, every_row=True)
    worst = {True: (0.0, -1), False: (0.0, -1)}     # wo input or not
    for i, ((x, _), c) in enumerate(zip(forcing.card_log["bf16"],
                                        forcing.cpu_in["bf16"])):
        gap = (c.float() - x.float()).abs()
        scale = x.float().abs().max().item()
        key = ("bf16", i) in loose
        share = (gap / (1e-5 * scale + loose[("bf16", i)])).max().item() \
            if key else gap.max().item() / scale
        worst[key] = max(worst[key], (share, i))
    log(f"serving decode step: attention outputs (wo inputs) card vs CPU "
        f"use at most {worst[True][0]:.3e} of their tolerance 1e-5 * max + "
        f"2^-8 * mag (step {worst[True][1]}); the other bf16 steps' inputs "
        f"within {worst[False][0]:.3e} of their max (step {worst[False][1]});"
        f" {time.perf_counter() - t0:.1f} s")
    return diff


def phase_plain_int8(torch, path: str):
    """One 64-token prefill block in mode pallas-int8 at full size on the
    card against the CPU plain path, step by step (see Forcing): the card's
    per-(row, k-tile) activation quantizations, bf16 attention dot operands
    and int8 KV encodes forced on the CPU; every op between them within
    1e-5 of its max, every rounding step bit for bit, the logits within
    1e-3 * max|logits| and the argmax equal at the position whose CPU top-2
    gap is widest."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer.from_file(path).encode(PROMPT)[:64]
    mode = "pallas-int8"
    forcing = Forcing(mode)
    t0 = time.perf_counter()

    def logits_of(device, spy):
        cfg, params = model.load_params(path, mode=mode, max_seq_len=256,
                                        device=device)
        k, v = model.init_kv_cache(cfg, 1, 256, "int8", device)
        with forcing.spy(spy):
            logits, _, _ = model.forward(params, cfg,
                                         torch.tensor([ids], device=device),
                                         k, v, 0, mode=mode, all_logits=True)
        return cfg, logits[0].float().cpu()

    cfg, card = logits_of("cuda", "record")
    torch.cuda.empty_cache()
    _, cpu = logits_of("cpu", "forced")
    if card.shape != (64, cfg.vocab_size) or not torch.isfinite(card).all():
        fail(f"pallas-int8 block logits: shape {tuple(card.shape)} or "
             f"non-finite")
    diff = forcing.check(torch, "pallas-int8 prefill block (64 tokens)",
                         card, cpu, cfg)
    log(f"pallas-int8 block vs the CPU plain path: "
        f"{time.perf_counter() - t0:.1f} s")
    return diff


# -- phase 6 -------------------------------------------------------------------

def kernel_name(name: str) -> str:
    """A short name for a kernel in the trace: its own name without
    namespaces and template arguments, plus the innermost functor or op a
    PyTorch or CUTLASS kernel is templated on ("..._kernel[MulFunctor]")."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base.removeprefix("void "), maxsplit=1)[0]
    short = base.split("::")[-1].strip()
    inner = re.findall(r"\w+Functor|\w+Ops\b|cutlass_\w+|\w+Prologue\b",
                       name)
    return f"{short}[{inner[-1]}]" if inner else short


# the trace names of the matmul kernels (csrc/q8_matmul.cu, q8i8_matmul.cu,
# q8_fused.cu: the fused ones carry their loader, "q8q8_gemv_kernel[
# XqPrologue]"), summed as the profiles' matmul time
MATMUL_KERNELS = ("q8q8", "q8_fast", "q8i8")


def trace_busy(prof, path: str):
    """(device busy us, kernel events, span us, {short name: us}) from a
    profiler's Chrome trace, or None when it holds no kernel events."""
    trace = Path(path).with_suffix(".trace.json")
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sorted((float(e["ts"]), float(e["dur"]), e["name"])
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        return None
    busy, end = 0.0, kernels[0][0]
    by_name: dict[str, float] = {}
    for ts, dur, name in kernels:
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
        short = kernel_name(name)
        by_name[short] = by_name.get(short, 0.0) + dur
    return busy, len(kernels), end - kernels[0][0], by_name


def phase_profile(torch, path: str, fuse: bool = False,
                  mode: str = "pallas"):
    """Where a decode step's time goes, over a warm greedy completion (one
    64-row prefill block, then PROFILE_STEPS decode steps; in `mode`, its
    matmuls
    fused when `fuse`): first timed alone, then again under torch.profiler,
    read from its Chrome trace. Reports device time by kernel, kernels per
    forward pass, and the device's idle share: 1 - busy / wall, with the
    busy time from the trace and the wall time from the run without the
    profiler (whose own overhead would inflate it); the share within the
    profiled span is printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig

    eng = Engine(EngineConfig(path=path, temperature=0.0, seed=1,
                              mode=mode, kv_dtype="int8", seq_len=4096,
                              device="cuda", fuse=fuse))
    prompt = PROMPT[:60]
    eng.generate(prompt, max_tokens=8)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = eng.generate(prompt, max_tokens=PROFILE_STEPS)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    calls = model.CALLS["forward"] + model.CALLS["decode_forward"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompt, max_tokens=PROFILE_STEPS)
        torch.cuda.synchronize()
    passes = model.CALLS["forward"] + model.CALLS["decode_forward"] - calls
    got = trace_busy(prof, path)
    if got is None:
        log("profile: the trace holds no kernel events; device time not "
            "measured")
        return None
    busy, n_kernels, span, by_name = got
    matmul = sum(v for k, v in by_name.items()
                 if k.startswith(MATMUL_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    label = f"cli {mode}" + (" fuse" if fuse else "")
    before = PROFILE_BEFORE.get(label, (None, None))
    out = dict(label=label, mode=mode, fuse=fuse, wall_ms=wall_ms,
               n_generated=plain.n_generated,
               prompt_ms=plain.prompt_ms, generate_ms=plain.generate_ms,
               ms_per_token=plain.ms_per_token, forward_passes=passes,
               kernels=n_kernels, kernels_per_pass=n_kernels / passes,
               before_kernels_per_pass=before[0],
               device_busy_ms=busy / 1e3,
               device_busy_ms_per_pass=busy / 1e3 / passes,
               before_device_busy_ms_per_pass=before[1],
               matmul_kernel_ms=matmul / 1e3,
               device_idle_share=1.0 - busy / 1e3 / wall_ms,
               profiled_span_ms=span / 1e3,
               profiled_idle_share=1.0 - busy / span,
               top_kernels_ms={k: v / 1e3 for k, v in top})
    log("profile " + json.dumps(out))
    return out


def phase_chunk_profile(torch, path: str, workdir: Path):
    """The fused chunk at qwen3-0.6b with qwen3-4b's headline settings
    (phase_fused_4b): mode pallas, a 1024-row bf16 cache, greedy from token
    7 at position 0, chunks of 32; one warm chunk profiled
    (chunk_profile)."""
    from qwen3_tpu_torch.models.qwen3 import init_kv_cache
    from qwen3_tpu_torch.runtime.decode_loop import decode_chunk
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig
    from qwen3_tpu_torch.runtime.xorshift import seed_to_device

    eng = Engine(EngineConfig(path=path, temperature=0.0, mode="pallas",
                              seq_len=1024, device="cuda"))
    cfg, dev, rows = eng.model_cfg, eng.device, 1024
    k, v = init_kv_cache(cfg, 1, rows, "bfloat16", dev)
    hi, lo = seed_to_device(3, dev)
    tok = torch.full((1,), 7, dtype=torch.int64, device=dev)
    pos = 0
    sp = eng.tokenizer.special

    def chunk():
        nonlocal k, v, tok, hi, lo, pos
        packed, k, v, tok, _, hi, lo = decode_chunk(
            eng.params, cfg, k, v, tok, pos, rows, hi, lo, mode="pallas",
            chunk=32, temperature=eng.sampler.temperature, top_p=0.9,
            greedy=True, bos=sp.bos, eos=sp.eos, top_k=64)
        row = packed.cpu()
        pos = min(pos + int(row[-2]), rows)
        return row

    out = chunk_profile(torch, "qwen3-0.6b fused chunk, ctx 1024", chunk,
                        32, str(workdir / "chunk06b"))
    del eng, k, v
    torch.cuda.empty_cache()
    return out


def phase_serving_profile(torch, path: str, batch: int, seq_len: int):
    """Where a serving decode step's time goes: a BatchedEngine with the
    serve defaults but `batch` slots and a `seq_len` context (pallas-fast,
    int8, fused), every slot admitted, one warm chunk, then one chunk of
    PROFILE_STEPS steps timed alone and one under torch.profiler. Reports wall and device
    time per step, kernels per step and the device's idle share (busy from
    the trace, wall from the run without the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request

    eng = BatchedEngine(path, max_batch=batch, seq_len=seq_len,
                        mode="pallas-fast", kv_dtype="int8", temperature=0.0,
                        decode_chunk=PROFILE_STEPS, device="cuda")
    for i in range(batch):
        eng.submit(Request(prompt=PROMPT[:60 + 25 * (i % 8)], seed=i,
                           max_tokens=400))
    eng._admit()
    eng._step()                                   # warm
    torch.cuda.synchronize()
    steps0 = model.CALLS["decode_forward"]
    t0 = time.perf_counter()
    eng._step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = model.CALLS["decode_forward"] - steps0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._step()
        torch.cuda.synchronize()
    got = trace_busy(prof, path)
    if got is None:
        log("serving profile: the trace holds no kernel events; device "
            "time not measured")
        return None
    busy, n_kernels, span, by_name = got
    matmul = sum(v for k, v in by_name.items()
                 if k.startswith(MATMUL_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    before = PROFILE_BEFORE.get(f"serving B={batch}", (None, None))
    out = dict(batch=batch, seq_len=seq_len, steps=steps,
               wall_ms_per_step=wall_ms / steps,
               device_busy_ms_per_step=busy / 1e3 / steps,
               before_device_busy_ms_per_step=before[1],
               matmul_kernel_ms_per_step=matmul / 1e3 / steps,
               device_idle_share=1.0 - busy / 1e3 / wall_ms,
               profiled_idle_share=1.0 - busy / span,
               kernels_per_step=n_kernels / steps,
               before_kernels_per_step=before[0],
               tok_s=batch * steps / wall_ms * 1e3,
               top_kernels_ms={k: v / 1e3 for k, v in top})
    log("serving profile " + json.dumps(out))
    return out


# -- report --------------------------------------------------------------------

def matmul_entry(name, source, line, mine, per_pass, launches):
    """A matmul kernel's line: the sums over `per_pass` rows ((row,
    launches a pass)) of one forward pass, the worst difference over all
    its rows `mine`."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"qwen3_tpu_torch/csrc/{source}",
        "replaces": f"qwen3_tpu/ops/pallas/q8_matmul.py:{line}",
        "launches": launches,
        "max_abs_err": max(r["max_abs_diff"] for r in mine),
        "ms": sum(r["kernel_ms"] * k for r, k in per_pass),
        "plain_ms": sum(r["plain_ms"] * k for r, k in per_pass),
        "bound_ms": sum(r["bound_ms"] * k for r, k in per_pass),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r, _ in per_pass) else "operations",
        "library_ms": sum(r["library_ms"] * k for r, k in per_pass),
    }


def norm_entries(norm_rows, fold_rows, on_paths):
    """The kernels line's entries of the norm kernel's four entry points:
    per decoded token at b = 1 (norm_token), their launches by
    on_paths(key)."""
    token = norm_token(norm_rows, fold_rows)
    out = []

    def norm_entry(name, replaces, keys, err, per_token):
        return {"name": name, "route": "cuda",
                "source": "qwen3_tpu_torch/csrc/rmsnorm.cu",
                "replaces": replaces, "pallas": None,
                "launches": sum(on_paths(k) for k in keys),
                "max_abs_err": err, **per_token, "bound_by": "bytes"}

    def fold_err(fold):
        return max(r["max_abs_diff"] for r in fold_rows if r["fold"] == fold)

    t = token["rmsnorm"]
    out.append(norm_entry(
        "rmsnorm", "qwen3_tpu/ops/norms.py:11", ("rmsnorm", "rms_inv"),
        max(r["max_abs_diff"] for r in norm_rows),
        {k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                           "library_ms")}))
    add = next(r for r in fold_rows if r["fold"] == "add_rmsnorm"
               and r["n"] == 1024 and r["b"] == 1)
    k_add = FOLD_PER_TOKEN["add_rmsnorm"]
    out.append(norm_entry(
        "add_rmsnorm", "qwen3_tpu/ops/norms.py:11", ("add_rmsnorm",),
        fold_err("add_rmsnorm"),
        {k: k_add * add[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "library_ms")}))
    out.append(norm_entry(
        "add_rms_inv", "qwen3_tpu/ops/norms.py:18", ("add_rms_inv",),
        fold_err("add_rmsnorm"),
        {"kernel_ms": k_add * add["add_rms_inv_ms"],
         "plain_ms": k_add * add["add_rms_inv_plain_ms"],
         "bound_ms": k_add * 1e3 * 4 * (3 * 1024 + 1) / HBM_BYTES_PER_S,
         "library_ms": None}))
    t = token["qk_norm_rope"]
    out.append(norm_entry(
        "qk_norm_rope", "qwen3_tpu/ops/rope.py:32", ("qk_norm_rope",),
        fold_err("qk_norm_rope"),
        {k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                           "library_ms")}))
    for e in out:
        e["ms"] = e.pop("kernel_ms")
    return out


def kernel_report(rows, flash_rows, flash_err, fast_rows, serve_rows,
                  serve_err, int8_rows, fused_rows, kv_rows, untiled_rows,
                  probe, counts, norm_rows, shard_rows, sampler_rows,
                  rows_8b, fold_rows):
    """Per kernel, one decoded token at the main path's shapes: the matmuls
    at b = 1 (4 stacked x 28 layers, 1 classifier), their launches over the
    path below depth 8192 and the fused and side path (phase 4e); flash
    decode at depth 8192 and flash prefill per 512-row block at start 8192
    (28 launches each), their launches over the long-context path (flash
    decode's also over the fused and side path). The serving kernels per
    decode step of the serve defaults (B = 8): the fast matmuls at b = 8,
    batched decode at B = 8 over 1152 rows (fast), two-segment flash at base
    8192 (B = 1), their launches over the serving path (two-segment flash's
    also over the fused and side path). The int8 and fused kernels per decoded
    token at b = 1: the int8 matmuls (4 stacked x 28, 1 classifier) and the
    fused matmul in mode pallas (exact: 4 x 28 layer matmuls and the
    classifier), their launches over the modes path. The kernels that no
    path runs, with their launches over every path (0): the KV row write
    for one call at the B = 64 cache in bf16; the untiled matmuls per
    decoded token at b = 1 (q8_matmul_pallas in the JAX defaults, f32
    pre-scaled). The pure reads per layer of qwen3-4b's w13 (the manual
    ring at its fastest n_buf), their launches over the probe path. The
    norm kernel's four entries, the port's own (the JAX package's norms and
    rope are XLA, no Pallas kernel replaces them): per decoded token at b =
    1 (2 rmsnorm, 2 x 28 - 1 add_rmsnorm or add_rms_inv, 28 qk_norm_rope
    launches, norm_token), their launches over every path but the probe's
    (rmsnorm's with rms_inv's). The tensor-parallel path (phase 4f,
    rank 0's counts) adds its launches to the kernels it runs (the q8q8,
    fast and batched decode kernels and the norms), and each matmul kernel
    also carries `tp2_ms`/`tp2_bound_ms`: a decoded token's launches at one
    tp = 2 rank's qwen3-0.6b shard shapes (phase_shard_kernels, b = 1).
    The 8B path (phase 4g) adds its launches to the kernels it runs, and
    the matmul kernels it can run carry `8b_ms`/`8b_bound_ms`: a decoded
    token's launches at its widths (phase_8b_kernels, b = 1). The
    sampler's two kernels, the port's own (the JAX package's sampler sums
    are XLA): one call at b = 1 at vocabulary 151936, their launches over
    every path."""
    out = []

    def e8b(kind, stacked):
        mine = [r for r in rows_8b if r["kernel"] == kind and r["b"] == 1
                and (r["matrix"] != "classifier") == stacked]
        k = L8B if stacked else 1
        return {"8b_ms": k * sum(r["kernel_ms"] for r in mine),
                "8b_bound_ms": k * sum(r["bound_ms"] for r in mine)}

    def tp2(kind, stacked):
        mine = [r for r in shard_rows if r.get("preset") == "qwen3-0.6b"
                and r["kernel"] == kind and r["b"] == 1
                and (r["matrix"] != "classifier") == stacked]
        k = L if stacked else 1
        return {"tp2_ms": k * sum(r["kernel_ms"] for r in mine),
                "tp2_bound_ms": k * sum(r["bound_ms"] for r in mine)}

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
            "launches": (counts["short"][kind] + counts["fused"][kind]
                         + counts["tp"][kind] + counts["e2e_8b"][kind]),
            "max_abs_err": max(r["max_abs_diff"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in dec) * per_token,
            "plain_ms": sum(r["plain_ms"] for r in dec) * per_token,
            "bound_ms": total_bytes_ms,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in dec) else "operations",
            "library_ms": sum(r["library_ms"] for r in dec) * per_token,
            **tp2("q8q8", kind == "stacked"),
            **e8b("q8q8", kind == "stacked"),
        })
    for kind, source_line, t in (("flash_decode", 115, 1),
                                 ("flash_prefill", 391, 512)):
        r = next(r for r in flash_rows if r["kernel"] == kind
                 and r["depth"] == FLASH_DEPTH and r["T"] == t)
        out.append({
            "name": f"{kind}_gqa",
            "route": "cuda",
            "source": "qwen3_tpu_torch/csrc/flash_decode.cu",
            "replaces": f"qwen3_tpu/ops/pallas/flash_decode.py:{source_line}",
            "launches": (counts["long"][kind] + counts["fused"][kind]
                         + counts["e2e_8b"][kind]),
            "max_abs_err": flash_err[kind],
            "ms": r["kernel_ms"] * L,
            "plain_ms": r["plain_ms"] * L,
            "bound_ms": r["bound_ms"] * L,
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] * L,
            # the prefill's bound in fp32 on CUDA cores, beside that of the
            # TF32 MMAs it runs
            **({"fp32_bound_ms": r["fp32_bound_ms"] * L}
               if kind == "flash_prefill" else {}),
        })
    for kind, source_line in (("stacked_fast", 476), ("tiled_fast", 263)):
        mine = [r for r in fast_rows if r["kernel"] == kind]
        step = [r for r in mine if r["b"] == 8]
        per_step = L if kind == "stacked_fast" else 1
        out.append({
            "name": f"q8_matmul_{kind}",
            "route": "cuda",
            "source": "qwen3_tpu_torch/csrc/q8_matmul.cu",
            "replaces": f"qwen3_tpu/ops/pallas/q8_matmul.py:{source_line}",
            "launches": counts["serve"][kind] + counts["tp"][kind],
            "max_abs_err": max(r["max_abs_diff"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in step) * per_step,
            "plain_ms": sum(r["plain_ms"] for r in step) * per_step,
            "bound_ms": sum(r["bound_ms"] for r in step) * per_step,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in step) else "operations",
            "library_ms": sum(r["library_ms"] for r in step) * per_step,
            **tp2("fast", kind == "stacked_fast"),
            **e8b("fast", kind == "stacked_fast"),
        })
    for name, count, src, line, pick in (
            ("batched_decode_partial", "batched_decode_partial",
             "batched_decode.cu", "batched_decode.py:136",
             lambda r: r.get("B") == 8 and r.get("fast")),
            ("flash_decode_gqa_two_segment", "flash_decode_two_segment",
             "flash_decode.cu", "flash_decode.py:231",
             lambda r: r.get("base") == FLASH_DEPTH)):
        r = next(r for r in serve_rows if r["kernel"] == name and pick(r))
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"qwen3_tpu_torch/csrc/{src}",
            "replaces": f"qwen3_tpu/ops/pallas/{line}",
            "launches": (counts["serve"][count] + counts["fused"][count]
                         + counts["tp"][count] + counts["e2e_8b"][count]),
            "max_abs_err": serve_err[name],
            "ms": r["kernel_ms"] * L,
            "plain_ms": r["plain_ms"] * L,
            "bound_ms": r["bound_ms"] * L,
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] * L,
        })
    for kind, line in (("stacked_int8", 570), ("tiled_int8", 624)):
        mine = [r for r in int8_rows if r["kernel"] == kind]
        k = L if kind == "stacked_int8" else 1
        out.append(matmul_entry(
            f"q8i8_matmul_{kind.split('_')[0]}", "q8i8_matmul.cu", line, mine,
            [(r, k) for r in mine if r["b"] == 1], counts["modes"][kind]))
        out[-1].update(tp2("int8", kind == "stacked_int8"))
    out.append(matmul_entry(
        "q8_matmul_fused", "q8_fused.cu", 748, fused_rows,
        [(r, 1 if r["matrix"] == "classifier" else L) for r in fused_rows
         if r["b"] == 1 and r["exact"]], counts["modes"]["fused"]))
    stacked, tiled = tp2("fused_exact", True), tp2("fused_exact", False)
    out[-1].update({k: stacked[k] + tiled[k] for k in stacked})
    stacked, tiled = e8b("fused_exact", True), e8b("fused_exact", False)
    out[-1].update({k: stacked[k] + tiled[k] for k in stacked})

    def on_paths(key):
        return sum(c[key] for name, c in counts.items() if name != "probe")

    r = next(r for r in kv_rows if r["dtype"] == "bfloat16")
    out.append({
        "name": "kv_write_rows", "route": "cuda",
        "source": "qwen3_tpu_torch/csrc/kv_write.cu",
        "replaces": "qwen3_tpu/ops/pallas/kv_write.py:50",
        "launches": on_paths("kv_write"),
        "max_abs_err": max(r["max_abs_diff"] for r in kv_rows),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]})
    for name, count, prefix, kind, line in (
            ("q8_q8_matmul_pallas", "q8q8_pallas", "q8q8_", "q8q8_pallas", 96),
            ("q8_matmul_pallas", "pallas", "pallas_", "pallas_float32_pre",
             848)):
        mine = [r for r in untiled_rows if r["kernel"].startswith(prefix)]
        out.append(matmul_entry(
            name, "q8_untiled.cu", line, mine,
            [(r, 1 if r["matrix"] == "classifier" else L)
             for r in mine if r["b"] == 1 and r["kernel"] == kind],
            on_paths(count)))
    out += norm_entries(norm_rows, fold_rows, on_paths)
    for kind, line in (("softmax_sum", 149), ("prefix_sum", 104)):
        mine = [r for r in sampler_rows if r["kernel"] == kind]
        r = next(r for r in mine if r["vocab"] == 151936 and r["b"] == 1)
        out.append({
            "name": f"sampler_{kind}", "route": "cuda",
            "source": "qwen3_tpu_torch/csrc/sampler.cu",
            "replaces": f"qwen3_tpu/runtime/sampler.py:{line}",
            "pallas": None, "launches": on_paths(kind),
            "max_abs_err": max(r_["max_abs_diff"] for r_ in mine),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    probe_rows, probe_counts, plain_ms, nbytes = probe
    bound = 1e3 * (nbytes + 4 * 8 * 1024) / HBM_BYTES_PER_S
    for name, line, labels in (
            ("pure_read_stacked", 37, ("pure-read same walk",)),
            ("pure_read_manual", 70, tuple(f"manual DMA {k}-buffer"
                                           for k in (2, 3, 4)))):
        out.append({
            "name": name, "route": "cuda",
            "source": "qwen3_tpu_torch/csrc/probe_dma.cu",
            "replaces": f"tools/probe_dma.py:{line}",
            "launches": probe_counts[name], "max_abs_err": 0,
            "ms": min(ms for label, ms, _ in probe_rows if label in labels),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None})
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    seconds: dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its wall seconds kept under `name`."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            seconds[name] = round(seconds.get(name, 0.0)
                                  + time.perf_counter() - t0, 1)

    card, kind = phase_device(torch)
    # the paths below set QWEN3_TPU_FUSE themselves where they run fused
    os.environ.pop("QWEN3_TPU_FUSE", None)
    sys.path.insert(0, str(HERE))
    try:
        import qwen3_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not next to this script: {e}")
    timed("build", phase_build)
    if "--moe-only" in sys.argv[1:]:   # the expert layer's phase alone
        moe_rows = timed("moe_kernels", phase_moe_kernels, torch)
        log(f"phase seconds {json.dumps(seconds)}")
        print(json.dumps({"kernels": moe_report(moe_rows)}), flush=True)
        return 0
    rows = timed("kernels", phase_kernels, torch)
    flash_rows, flash_err = timed("flash", phase_flash_kernels, torch)
    fast_rows = timed("fast", phase_fast_kernels, torch)
    serve_rows, serve_err = timed("batched", phase_batched_kernels, torch)
    int8_rows = timed("int8", phase_int8_kernels, torch)
    fused_rows = timed("fused", phase_fused_kernels, torch)
    norm_rows = timed("norm", phase_norm_kernel, torch)
    fold_rows = timed("norm", phase_norm_folds, torch)
    log_norm_tokens(norm_rows, fold_rows)
    kv_rows = timed("kv_write", phase_kv_write, torch)
    untiled_rows = timed("untiled", phase_untiled_kernels, torch)
    shard_rows = timed("shard", phase_shard_kernels, torch)
    rows_8b = timed("8b_kernels", phase_8b_kernels, torch)
    moe_rows = timed("moe_kernels", phase_moe_kernels, torch)
    sampler_rows, _ = timed("sampler", phase_sampler_kernel, torch)
    timed("sampler", check_sampler, torch)
    workdir = HERE / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        path = timed("checkpoint", write_checkpoint, workdir)
        counts, _ = timed("end_to_end", phase_end_to_end, torch, path)
        reset_counts()
        timed("serving", phase_serving, torch, path, workdir)
        counts["serve"] = read_counts()
        log(f"serving path launches (the runs above): {counts['serve']}")
        if min(counts["serve"][k] for k in (
                "stacked_fast", "tiled_fast", "batched_decode_partial",
                "flash_decode_two_segment", "rmsnorm", "add_rmsnorm",
                "qk_norm_rope", "softmax_sum", "prefix_sum")) == 0:
            fail("a kernel of the serving path was never launched")
        reset_counts()
        timed("modes", phase_modes, torch, path, workdir)
        counts["modes"] = read_counts()
        log(f"modes path launches (the runs above): {counts['modes']}")
        if min(counts["modes"][k] for k in (
                "stacked_int8", "tiled_int8", "fused", "rmsnorm",
                "add_rmsnorm", "rms_inv", "add_rms_inv", "qk_norm_rope",
                "softmax_sum", "prefix_sum")) == 0:
            fail("a kernel of the modes path was never launched")
        t4e = time.perf_counter()
        timed("chunk_checks", phase_chunk_checks, torch, path)
        reset_counts()
        timed("decode_programs", phase_decode_programs, torch, path)
        tok_s_4b, _ = timed("fused_4b", phase_fused_4b, torch, card, workdir)
        counts["fused"] = read_counts()
        log(f"fused and side path launches (the runs above): "
            f"{counts['fused']}; qwen3-4b tok/s {tok_s_4b} ({card}); "
            f"{time.perf_counter() - t4e:.1f} s")
        if min(counts["fused"][k] for k in (
                "stacked", "tiled", "flash_decode",
                "flash_decode_two_segment", "rmsnorm", "add_rmsnorm",
                "qk_norm_rope", "softmax_sum", "prefix_sum")) == 0:
            fail("a kernel of the fused and side path was never launched")
        counts["tp"], tp_res = timed("tp", phase_tp_paths, torch, path,
                                     workdir, card)
        counts["e2e_8b"], _ = timed("e2e_8b", phase_e2e_8b, torch, workdir,
                                    card)
        log(f"8b path launches (the run above): {counts['e2e_8b']}")
        timed("quality", phase_quality, torch, path, workdir)
        timed("host_tools", phase_host_tools, torch, path, workdir)
        probe = timed("probe", phase_probe, torch)
        counts["probe"] = probe[1]
        timed("plain_path", phase_plain_path, torch, path)
        timed("plain_depth", phase_plain_depth, torch, path)
        timed("serving_plain", phase_serving_plain, torch, path)
        timed("plain_int8", phase_plain_int8, torch, path)
        timed("profile", phase_profile, torch, path)
        timed("profile", phase_profile, torch, path, fuse=True)
        timed("profile", phase_profile, torch, path, mode="pallas-int8")
        timed("profile", phase_chunk_profile, torch, path, workdir)
        timed("profile", phase_serving_profile, torch, path, 8, 1024)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        log(f"phase seconds {json.dumps(seconds)}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    report = kernel_report(
        rows, flash_rows, flash_err, fast_rows, serve_rows, serve_err,
        int8_rows, fused_rows, kv_rows, untiled_rows, probe, counts,
        norm_rows, shard_rows, sampler_rows, rows_8b, fold_rows) + \
        moe_report(moe_rows)
    log("tp results " + json.dumps(tp_res))
    for e in report:
        if e["name"] in BEFORE_MS:
            log(f"redesigned {e['name']}: {e['ms']:.4f} ms, recorded "
                f"before {BEFORE_MS[e['name']]} ms, library "
                f"{e['library_ms']:.4f} ms")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
