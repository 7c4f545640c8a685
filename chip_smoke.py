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
   Q8_0 matmuls (b = 1, 64, 256, 512) and the pallas-fast matmuls (b = 1,
   8, 64, 128, 512) bit for bit, the latter also across batch sizes; the
   flash kernels, batched decode (B = 8 and 64) and two-segment flash
   within their tolerances; the pallas-int8 matmuls (b = 1, 8, 64, 256, 512)
   bit for bit and across batch sizes; the fused-prologue matmul for each
   (prologue, exact/fast) pair of the main path (b = 1, 8, 64, 512) against
   its plain version and the unfused kernel; the KV row write at the B = 64
   serving cache (f32, bf16) and the untiled matmuls on [n, d] weights
   (b = 1, 8, 512; the exact one bit for bit, the dequant one in f32 and
   bf16, pre- and post-scaled, within 1e-5 * max|plain|), which only the
   tests call; then the sampler on the card against its CPU run at the
   vocabulary of qwen3-0.6b (see check_sampler);
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
   its forward passes need; 4b. the quality table on the same checkpoint at
   -c 1024 (see phase_quality); 4c. the host tools (model_check,
   tokenizer_check, the native encode against the Python one on every
   prompt, the CLI with --profile, see phase_host_tools); 4d. the DMA
   probe at qwen3-4b's full width (tools/probe_dma.py: the Q8_0 GEMV
   against the pure-read kernels, their checksums against the plain
   version, no rate past 1.05 x 3.35 TB/s; see phase_probe);
5. the path against its plain version, step by step with the card's
   rounding decisions forced on the CPU (every op within 1e-5 of its max,
   every rounding step bit for bit, logits and argmax): a 64-token prefill
   block (and free-running within twice the CPU path's own spread under a
   one-ulp nudge of its input, see phase_plain_path), the flash block and
   step at depth 8192, one serving decode step at B = 8 (see
   phase_serving_plain) and a 64-token pallas-int8 block;
6. profile: torch.profiler over a warm greedy completion (one prefill
   block, 64 decode steps), unfused and with the fused matmuls, and over one 32-step serving chunk at B = 8
   (-c 1024) and at B = 64 (-c 512):
   device time by kernel, kernels per step and the device's idle share.

The last two lines are a JSON object of per-kernel numbers and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
BATCHES = (1, 64, 256, 512)    # decode, and the prefill ladder's blocks
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 peak outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
# flash attention at qwen3-0.6b's shape, in the CLI's default 32768-row cache
FLASH_H, FLASH_KV, FLASH_D, FLASH_S = 16, 8, 128, 32768
FLASH_DEPTHS = (0, 255, 256, 8191, 16384, 32767)   # decode positions
FLASH_BLOCKS = (64, 512)                           # prefill block rows
FLASH_STARTS = (0, 8192, 32256)                    # prefill block starts
FLASH_TIMED = (("flash_decode", 8192, 1), ("flash_decode", 16384, 1),
               ("flash_decode", 32767, 1), ("flash_prefill", 8192, 64),
               ("flash_prefill", 8192, 512), ("flash_prefill", 32256, 512))
FLASH_DEPTH = 8192             # --attn auto switches to flash here
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


def attn_bound_ms(q_rows, rows_read, score_pairs, fast=False, outputs=None):
    """The least time for one attention launch: the bytes it must move (the
    f32 queries, the int8 K/V values and f32 scales of the rows it reads,
    once each, and `outputs` f32 values, by default one a query value) over
    the memory rate, or its operations (2 for q . k and 2 for p v per score
    pair and head dim) over the peak of the dots' type (bf16 when `fast`,
    else fp32 outside the tensor cores)."""
    if outputs is None:
        outputs = q_rows * FLASH_H * FLASH_D
    nbytes = 4 * q_rows * FLASH_H * FLASH_D + 4 * outputs + \
        2 * rows_read * FLASH_KV * (FLASH_D + 4)
    ops = 4 * score_pairs * FLASH_H * FLASH_D
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
    flash tolerance). Then times for int8 (the main path's cache) over a
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
        for t in FLASH_BLOCKS:
            for start in FLASH_STARTS:
                q = torch.randn(1, t, FLASH_H, FLASH_D, device="cuda",
                                generator=gen)
                qpos = torch.arange(start, start + t, dtype=torch.int32,
                                    device="cuda")
                want = fd.flash_prefill_plain(q, kl, vl, qpos, ksl, vsl,
                                              live=start + t)
                got = fd.flash_prefill_gqa(q, kl, vl, qpos, ksl, vsl)
                diffs.append(check("flash_prefill", got, want,
                                   f"{dtype} T {t} start {start}"))
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

            def kernel(i, q=q, pos=pos):
                return fd.flash_prefill_gqa(q, k[i % L], v[i % L], pos,
                                            ks[i % L], vs[i % L])

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
        bnd, by = attn_bound_ms(t, n, pairs)
        row = dict(kernel=kind, depth=depth, T=t, rows_read=n,
                   kernel_ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain),
                   library_ms=device_ms(torch, library), bound_ms=bnd,
                   bound_by=by, library_vs_kernel_max_abs_diff=lib_diff)
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
# batched decode partials: (slots, bucket), the serving engine's cache rows
# for -c 1024 and -c 512 (+ 32 side rows, padded to 128)
BATCHED_CASES = ((8, 1152), (64, 640))
SIDE_C = 32                    # the serving decode chunk
TWO_SEG_BASES = (0, 8192, 32736)
TWO_SEG_ROWS = 33024           # -c 32768 + 32, padded to 256


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
    kernel's p is relative to the running max of its 64-row chunks, the
    plain version's to that of the Pallas kernel's tiles, so the two round
    each term independently. Their gap could reach 2^-7 * mag only if every
    term's two roundings fell at opposite extremes; 2^-8 * mag is half
    that. A slot of at most 64 rows has one frame in both, and no gap."""
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
                       bound_by=by)
            rows.append(row)
            log("fast " + json.dumps(row))
        del w_q, w_s, w_bf
        torch.cuda.empty_cache()
    log(f"fast matmuls: every row bit-equal at b in {list(FAST_BATCHES)}; "
        "library_ms = torch.nn.functional.linear on bf16 with the weights "
        "dequantized once to bf16")
    return rows


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
                torch.cuda.synchronize()
                if not all(torch.isfinite(t).all() for t in got):
                    fail(f"batched_decode B={B} fast={fast}: non-finite")
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
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        tol = 2e-5 * max(1.0, want.abs().max().item())
        if not torch.isfinite(got).all() or diff > tol:
            fail(f"two-segment flash at base {base}: max_abs_diff "
                 f"{diff:.3e} > {tol:.3e}")
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
    the same row in the b = 512 call. Times as phase_kernels' (the wrapper,
    which quantizes the activations per (row, k-tile) with PyTorch ops
    before the kernel, as the JAX function does with XLA ops)."""
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
    row of the b = 512 call. Times: the kernel, its plain
    version, and as the library yardstick the unfused chain (the plain
    prologue ops, the quantization or bf16 rounding, and the unfused
    kernel)."""
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
                # the widest call's row factors: torch.mean's reduction order
                # on the card may follow the number of rows, and the kernel's
                # batch invariance is checked on the same inputs
                inv = None if inv_all is None else inv_all[:b].contiguous()
                if inv is not None and not torch.equal(inv, row_inv(x)):
                    log(f"fused {name}: rms_inv of {b} rows differs from the "
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
                row = dict(
                    matrix=name, prologue=prologue, exact=exact, b=b, n=n,
                    d=d, max_abs_diff=max(gaps),
                    kernel_ms=device_ms(torch, lambda i: kernel(x, inv)),
                    plain_ms=device_ms(torch, lambda i: plain(x, inv),
                                       reps=3),
                    library_ms=device_ms(torch, lambda i: unfused(x, inv)),
                    bound_ms=bnd, bound_by=by)
                rows.append(row)
                log("fused " + json.dumps(row))
        del w_q, w_s
        torch.cuda.empty_cache()
    log("fused matmul: bit-equal to its plain version and to the unfused "
        "kernel on the plain prologue everywhere; library_ms = the unfused "
        "chain (plain prologue ops + quantize_act or the bf16 rounding + the "
        "q8q8 or fast tile kernel)")
    return rows


KV_CACHE = (28, 64, 512, 8, 128)   # qwen3-0.6b's cache at serve --batch 64 -c 512


def phase_kv_write(torch):
    """kv_write_rows (the JAX package's in-place per-slot row write, which
    no path runs) at qwen3-0.6b's B = 64 serving cache [28, 64, 512, 8,
    128], f32 and bf16, layers 0 and 27, positions with both edges and a
    duplicate: bit-equal to its plain version, and every row it did not
    write unchanged. Times: the kernel, its plain version, and as the
    library yardstick the same indexed assignment as one index_put_. The
    bound: the f32 rows read once and written once in the cache's type,
    over the memory rate."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    n_layers, B, S, KV, D = KV_CACHE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows_in = torch.randn(B, KV, D, device="cuda", generator=gen)
    pos = torch.randint(0, S, (B,), device="cuda", generator=gen)
    pos[:4] = torch.tensor([0, S - 1, 7, 7], device="cuda")
    slots = torch.arange(B, device="cuda")
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        cache = torch.randn(KV_CACHE, device="cuda", generator=gen).to(dtype)
        for layer in (0, n_layers - 1):
            got = kw.kv_write_rows(cache.clone(), rows_in, layer, pos)
            want = kw.kv_write_rows_plain(cache.clone(), rows_in, layer, pos)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"kv_write {dtype} layer={layer}: kernel != plain")
            got[layer, slots, pos] = cache[layer, slots, pos]
            if not torch.equal(got, cache):
                fail(f"kv_write {dtype} layer={layer}: a row it did not "
                     f"write changed")
            del got, want
        cast = rows_in.to(dtype)

        def library(i):
            cache[i % n_layers].index_put_((slots, pos), cast)

        es = cache.element_size()
        row = dict(kernel="kv_write_rows", dtype=str(dtype).split(".")[-1],
                   cache=list(KV_CACHE), max_abs_diff=0.0,
                   kernel_ms=device_ms(torch, lambda i: kw.kv_write_rows(
                       cache, rows_in, i % n_layers, pos)),
                   plain_ms=device_ms(torch, lambda i: kw.kv_write_rows_plain(
                       cache, rows_in, i % n_layers, pos)),
                   library_ms=device_ms(torch, library),
                   bound_ms=1e3 * (B * KV * D * (4 + es) + 4 * B)
                   / HBM_BYTES_PER_S, bound_by="bytes")
        out.append(row)
        log("kv_write " + json.dumps(row))
        del cache
        torch.cuda.empty_cache()
    return out


UNTILED_BATCHES = (1, 8, 512)
# q8_matmul_pallas's (compute dtype, postscale) pairs
UNTILED_MODES = (("float32", False), ("float32", True), ("bfloat16", False),
                 ("bfloat16", True))


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


def phase_untiled_kernels(torch):
    """The untiled matmuls on contraction-leading weights (which only the
    JAX package's tests call) at qwen3-0.6b's five matrices in [n, d]
    layout, b in UNTILED_BATCHES: q8_q8_matmul_pallas bit for bit against
    its plain version; q8_matmul_pallas in f32 and bf16, pre- and
    post-scaled, within 1e-5 * max|plain| (the kernel sums each dot as an
    fmaf chain in k order, the plain version's torch.matmul in its own
    order; bf16 products are exact in fp32). Times: the kernel, its plain
    version and as the library yardstick F.linear on bf16 with the weights
    dequantized once to bf16 (bound_ms for q8q8 as phase_kernels')."""
    import torch.nn.functional as F

    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.ops.q8 import quantize_act

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows = []
    for name, (n, d) in MATRICES.items():
        w_q = torch.randint(-127, 128, (n, d), dtype=torch.int8,
                            device="cuda", generator=gen)
        w_s = 0.02 / 127 * (0.5 + torch.rand(n // G, d, device="cuda",
                                             generator=gen))
        w_bf = (w_q.float().reshape(n // G, G, d) * w_s[:, None, :]).reshape(
            n, d).T.contiguous().to(torch.bfloat16)
        for b in UNTILED_BATCHES:
            x = torch.randn(b, n, device="cuda", generator=gen)
            xq, xs = quantize_act(x, G)
            x_bf = x.to(torch.bfloat16)

            def library(i, x_bf=x_bf):
                return F.linear(x_bf, w_bf)

            l_ms = device_ms(torch, library)
            got = qm.q8_q8_matmul_pallas(xq, xs, w_q, w_s, G)
            want = qm.q8_q8_matmul_pallas_plain(xq, xs, w_q, w_s, G)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or not torch.equal(got, want):
                fail(f"untiled q8q8 {name} b={b}: kernel != plain "
                     f"(max_abs_diff {err:.3e})")
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
                rows.append(row)
                log("untiled " + json.dumps(row))
        del w_q, w_s, w_bf
        torch.cuda.empty_cache()
    log("untiled matmuls: q8q8 bit-equal to its plain version everywhere, "
        "the dequant kernel within 1e-5 * max|plain|; library_ms = "
        "torch.nn.functional.linear on bf16 with the weights dequantized "
        "once to bf16")
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
    from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
    from qwen3_tpu_torch.tools import probe_dma as pd

    return qm, fd, bd, kw, pd


def want_launches(calls):
    """What the forward passes counted in `calls` (models.qwen3.CALLS
    deltas) must launch: every pass 4 x 28 layer matmuls and 1 classifier
    matmul of its route's kernels (mode pallas the q8q8 kernels,
    pallas-fast the fast ones, pallas-int8 the int8 ones, with fuse the
    fused kernel for all 113; modes exact and bf16 no kernel); every pass
    that resolved to a kernel attention 28 launches of it (prefill blocks
    flash prefill; decode steps flash decode, or over the serving side
    buffer the two-segment flash or the batched decode kernel); no other
    pass launches an attention kernel; no pass launches the kernels that
    only the tests and the probe call (the KV row write, the untiled
    matmuls, the pure reads)."""
    mm = {route: calls["mm_" + route] for route in (
        "pallas", "pallas-fast", "pallas-int8", "fused")}
    return {"stacked": 4 * L * mm["pallas"], "tiled": mm["pallas"],
            "stacked_fast": 4 * L * mm["pallas-fast"],
            "tiled_fast": mm["pallas-fast"],
            "stacked_int8": 4 * L * mm["pallas-int8"],
            "tiled_int8": mm["pallas-int8"],
            "fused": (4 * L + 1) * mm["fused"],
            "flash_decode": L * calls["decode_forward_flash"],
            "flash_prefill": L * calls["forward_flash"],
            "flash_decode_two_segment":
                L * calls["decode_forward_two_segment"],
            "batched_decode_partial": L * calls["decode_forward_fused"],
            "kv_write": 0, "q8q8_pallas": 0, "pallas": 0,
            "pure_read_stacked": 0, "pure_read_manual": 0}


def checked(torch, label, fn):
    """Run fn() with the launch-count check (want_launches); returns
    (fn's result, {blocks, steps, launches, calls, wall})."""
    from qwen3_tpu_torch.models import qwen3 as model

    before, calls0 = read_counts(), dict(model.CALLS)
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c - before[k] for k, c in read_counts().items()}
    calls = {k: model.CALLS[k] - calls0[k] for k in model.CALLS}
    blocks, steps = calls["forward"], calls["decode_forward"]
    if steps == 0 or blocks == 0:
        fail(f"{label}: no prefill block or no decode step ran")
    want = want_launches(calls)
    if launches != want:
        fail(f"{label}: launches {launches} for passes {calls}; want {want}")
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
                               "192", "-y", "You are brief."],
        stdin_text="Tell me about the clockmaker.\nAnd the children?\n\n")
    if err.count("[t/ms") != 2:
        fail("chat: expected two turns with metrics")
    counts = {"short": read_counts()}
    log(f"main path launches below depth 8192 (the runs above): "
        f"{counts['short']}")
    if min(counts["short"][k] for k in ("stacked", "tiled")) == 0:
        fail("a matmul kernel of the path was never launched")

    reset_counts()
    runs.update(phase_long_context(torch, path))
    counts["long"] = read_counts()
    log(f"main path launches at long context (the runs above): "
        f"{counts['long']}")
    if min(counts["long"][k] for k in ("stacked", "tiled", "flash_decode",
                                       "flash_prefill")) == 0:
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
    64 tokens each, greedy, then seeded twice with equal records; --batch
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
        base + ["-t", "0", "-s", "42", "--max-tokens", "64"], prompts,
        workdir, "fused", 64)
    seeded = base + ["-t", "0.8", "-p", "0.9", "-s", "7", "--max-tokens",
                     "64"]
    rec1, runs["serve_seeded_1"] = checked_serve(
        torch, "serve seeded run 1", seeded, prompts, workdir, "fused", 64)
    rec2, runs["serve_seeded_2"] = checked_serve(
        torch, "serve seeded run 2", seeded, prompts, workdir, "fused", 64)
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


def phase_quality(torch, path: str):
    """Phase 4b: the port's quality table on the synthetic qwen3-0.6b at
    -c 1024, in two calls: the default modes (exact, pallas, pallas-fast,
    bf16) and the pallas+int8kv row, whose gate must pass; then exact and
    pallas-int8 (the JAX package's unadopted experiment), whose row is
    logged whether or not it passes. Returns both JSON objects."""
    from qwen3_tpu_torch.tools import quality_table

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
    keeps the input it was given."""

    def __init__(self, mode: str = "pallas"):
        from qwen3_tpu_torch.models import qwen3 as model
        from qwen3_tpu_torch.ops import attention
        from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
        from qwen3_tpu_torch.runtime import kvcache as kvc

        act = {"pallas": ("q8", model, "quantize_act"),
               "pallas-fast": ("bf16", model, "round_bf16"),
               "pallas-int8": ("q8i8", qm, "quantize_act")}[mode]
        self.sites = {act[0]: act[1:], "kv": (kvc, "quantize_heads")}
        if mode == "pallas-int8":
            self.sites["att"] = (attention, "dot_operand")
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

    @contextlib.contextmanager
    def spy(self, how):
        """how: None (the plain steps), "record" or "forced"."""
        for kind, (mod, name) in self.sites.items():
            setattr(mod, name, getattr(self, "_" + how)(kind) if how
                    else self.rounding[kind])
        try:
            yield
        finally:
            for kind, (mod, name) in self.sites.items():
                setattr(mod, name, self.rounding[kind])

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
    inner = re.findall(r"\w+Functor|\w+Ops\b|cutlass_\w+", name)
    return f"{short}[{inner[-1]}]" if inner else short


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


def phase_profile(torch, path: str, fuse: bool = False):
    """Where a decode step's time goes, over a warm greedy completion (one
    64-row prefill block, then 64 decode steps; mode pallas, its matmuls
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
                              kv_dtype="int8", seq_len=4096, device="cuda",
                              fuse=fuse))
    prompt = PROMPT[:60]
    eng.generate(prompt, max_tokens=8)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = eng.generate(prompt, max_tokens=64)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    calls = model.CALLS["forward"] + model.CALLS["decode_forward"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompt, max_tokens=64)
        torch.cuda.synchronize()
    passes = model.CALLS["forward"] + model.CALLS["decode_forward"] - calls
    got = trace_busy(prof, path)
    if got is None:
        log("profile: the trace holds no kernel events; device time not "
            "measured")
        return None
    busy, n_kernels, span, by_name = got
    matmul = sum(v for k, v in by_name.items()
                 if k.startswith(("q8q8", "q8_fast", "q8i8", "fused_")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(fuse=fuse, wall_ms=wall_ms, n_generated=plain.n_generated,
               prompt_ms=plain.prompt_ms, generate_ms=plain.generate_ms,
               ms_per_token=plain.ms_per_token, forward_passes=passes,
               kernels=n_kernels, kernels_per_pass=n_kernels / passes,
               device_busy_ms=busy / 1e3, matmul_kernel_ms=matmul / 1e3,
               device_idle_share=1.0 - busy / 1e3 / wall_ms,
               profiled_span_ms=span / 1e3,
               profiled_idle_share=1.0 - busy / span,
               top_kernels_ms={k: v / 1e3 for k, v in top})
    log("profile " + json.dumps(out))
    return out


def phase_serving_profile(torch, path: str, batch: int, seq_len: int):
    """Where a serving decode step's time goes: a BatchedEngine with the
    serve defaults but `batch` slots and a `seq_len` context (pallas-fast,
    int8, fused), every slot admitted, one warm chunk, then one 32-step
    chunk timed alone and one under torch.profiler. Reports wall and device
    time per step, kernels per step and the device's idle share (busy from
    the trace, wall from the run without the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request

    eng = BatchedEngine(path, max_batch=batch, seq_len=seq_len,
                        mode="pallas-fast", kv_dtype="int8", temperature=0.0,
                        device="cuda")
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(batch=batch, seq_len=seq_len, steps=steps,
               wall_ms_per_step=wall_ms / steps,
               device_busy_ms_per_step=busy / 1e3 / steps,
               device_idle_share=1.0 - busy / 1e3 / wall_ms,
               profiled_idle_share=1.0 - busy / span,
               kernels_per_step=n_kernels / steps,
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


def kernel_report(rows, flash_rows, flash_err, fast_rows, serve_rows,
                  serve_err, int8_rows, fused_rows, kv_rows, untiled_rows,
                  probe, counts):
    """Per kernel, one decoded token at the main path's shapes: the matmuls
    at b = 1 (4 stacked x 28 layers, 1 classifier), their launches over the
    path below depth 8192; flash decode at depth 8192 and flash prefill per
    512-row block at start 8192 (28 launches each), their launches over the
    long-context path. The serving kernels per decode step of the serve
    defaults (B = 8): the fast matmuls at b = 8, batched decode at B = 8
    over 1152 rows (fast), two-segment flash at base 8192 (B = 1), their
    launches over the serving path. The int8 and fused kernels per decoded
    token at b = 1: the int8 matmuls (4 stacked x 28, 1 classifier) and the
    fused matmul in mode pallas (exact: 4 x 28 layer matmuls and the
    classifier), their launches over the modes path. The kernels that no
    path runs, with their launches over every path (0): the KV row write
    for one call at the B = 64 cache in bf16; the untiled matmuls per
    decoded token at b = 1 (q8_matmul_pallas in the JAX defaults, f32
    pre-scaled). The pure reads per layer of qwen3-4b's w13 (the manual
    ring at its fastest n_buf), their launches over the probe path."""
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
            "launches": counts["short"][kind],
            "max_abs_err": max(r["max_abs_diff"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in dec) * per_token,
            "plain_ms": sum(r["plain_ms"] for r in dec) * per_token,
            "bound_ms": total_bytes_ms,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in dec) else "operations",
            "library_ms": sum(r["library_ms"] for r in dec) * per_token,
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
            "launches": counts["long"][kind],
            "max_abs_err": flash_err[kind],
            "ms": r["kernel_ms"] * L,
            "plain_ms": r["plain_ms"] * L,
            "bound_ms": r["bound_ms"] * L,
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] * L,
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
            "launches": counts["serve"][kind],
            "max_abs_err": max(r["max_abs_diff"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in step) * per_step,
            "plain_ms": sum(r["plain_ms"] for r in step) * per_step,
            "bound_ms": sum(r["bound_ms"] for r in step) * per_step,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in step) else "operations",
            "library_ms": sum(r["library_ms"] for r in step) * per_step,
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
            "launches": counts["serve"][count],
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
    out.append(matmul_entry(
        "q8_matmul_fused", "q8_fused.cu", 748, fused_rows,
        [(r, 1 if r["matrix"] == "classifier" else L) for r in fused_rows
         if r["b"] == 1 and r["exact"]], counts["modes"]["fused"]))

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

    _, kind = phase_device(torch)
    # the paths below set QWEN3_TPU_FUSE themselves where they run fused
    os.environ.pop("QWEN3_TPU_FUSE", None)
    sys.path.insert(0, str(HERE))
    try:
        import qwen3_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not next to this script: {e}")
    phase_build()
    rows = phase_kernels(torch)
    flash_rows, flash_err = phase_flash_kernels(torch)
    fast_rows = phase_fast_kernels(torch)
    serve_rows, serve_err = phase_batched_kernels(torch)
    int8_rows = phase_int8_kernels(torch)
    fused_rows = phase_fused_kernels(torch)
    kv_rows = phase_kv_write(torch)
    untiled_rows = phase_untiled_kernels(torch)
    check_sampler(torch)
    workdir = HERE / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        path = write_checkpoint(workdir)
        counts, _ = phase_end_to_end(torch, path)
        reset_counts()
        phase_serving(torch, path, workdir)
        counts["serve"] = read_counts()
        log(f"serving path launches (the runs above): {counts['serve']}")
        if min(counts["serve"][k] for k in (
                "stacked_fast", "tiled_fast", "batched_decode_partial",
                "flash_decode_two_segment")) == 0:
            fail("a kernel of the serving path was never launched")
        reset_counts()
        phase_modes(torch, path, workdir)
        counts["modes"] = read_counts()
        log(f"modes path launches (the runs above): {counts['modes']}")
        if min(counts["modes"][k] for k in (
                "stacked_int8", "tiled_int8", "fused")) == 0:
            fail("a kernel of the modes path was never launched")
        phase_quality(torch, path)
        phase_host_tools(torch, path, workdir)
        probe = phase_probe(torch)
        counts["probe"] = probe[1]
        phase_plain_path(torch, path)
        phase_plain_depth(torch, path)
        phase_serving_plain(torch, path)
        phase_plain_int8(torch, path)
        phase_profile(torch, path)
        phase_profile(torch, path, fuse=True)
        phase_serving_profile(torch, path, 8, 1024)
        phase_serving_profile(torch, path, 64, 512)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernel_report(
        rows, flash_rows, flash_err, fast_rows, serve_rows, serve_err,
        int8_rows, fused_rows, kv_rows, untiled_rows, probe, counts)}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
