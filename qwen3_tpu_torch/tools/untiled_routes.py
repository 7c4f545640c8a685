"""Time every route of q8_matmul_pallas's tile kernel (b > 8) at a preset's
layer matrices, to hold plan_untiled's choice against the fastest route.

    python -m qwen3_tpu_torch.tools.untiled_routes \
        [--models qwen3-0.6b,qwen3-4b] [--batches 65,512] \
        [--compute float32|bfloat16] [--postscale] [--reps 10] [--seed 0]

For each layer matrix of each preset in the untiled [n, d] layout (wqkv,
wo, w13, w2) and each b, every tile route (tile_routes: each shape of
UNTILED_TILE_SHAPES, each split that divides the k-tiles) is forced through
q8_untiled_launch on random weights made from --seed, its rows held
bit-equal to the planned route's, and timed with CUDA events (the median of
--reps runs, each queued behind a device spin so the host's launch does not
show). Prints one JSON line per (matrix, b): the planned route and its
time, the fastest route and its time, and every route's time; exits 1 if a
route's rows differ. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from qwen3_tpu_torch.config import PRESETS
from qwen3_tpu_torch.ops.cuda import q8_matmul as qm

SPIN_CYCLES = 2_000_000        # a device spin before each timed call


def layer_matrices(preset: str) -> list[tuple[str, int, int, int]]:
    """A preset's layer matrices in the untiled [n, d] layout: (label, n, d,
    G)."""
    c = PRESETS[preset]
    q = c.n_heads * c.head_dim
    kv = c.n_kv_heads * c.head_dim
    return [("wqkv", c.dim, q + 2 * kv, c.group_size),
            ("wo", q, c.dim, c.group_size),
            ("w13", c.dim, 2 * c.hidden_dim, c.group_size),
            ("w2", c.hidden_dim, c.dim, c.group_size)]


def tile_routes(n: int, group_size: int,
                block_k: int = 512) -> list[tuple[int, int]]:
    """Every (shape, splits) the tile kernel takes for a contraction of n:
    each shape of UNTILED_TILE_SHAPES, each split dividing the k-tiles."""
    nt = n // qm.pick_tile(n, 8 * group_size, block_k)
    return [(shape, splits) for shape in range(len(qm.UNTILED_TILE_SHAPES))
            for splits in range(1, nt + 1) if nt % splits == 0]


def _device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m qwen3_tpu_torch.tools.untiled_routes")
    p.add_argument("--models", default="qwen3-0.6b,qwen3-4b")
    p.add_argument("--batches", default="65,512")
    p.add_argument("--compute", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--postscale", action="store_true")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("untiled_routes: needs a CUDA device", file=sys.stderr)
        return 2
    cdt = getattr(torch, args.compute)
    batches = [int(b) for b in args.batches.split(",")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = 0
    for preset in args.models.split(","):
        for label, n, d, g in layer_matrices(preset):
            w_q = torch.randint(-127, 128, (n, d), dtype=torch.int8,
                                device="cuda", generator=gen)
            w_s = 0.02 / 127 * (0.5 + torch.rand(n // g, d, device="cuda",
                                                 generator=gen))
            x_all = torch.randn(max(batches), n, device="cuda",
                                generator=gen)
            for b in batches:
                x = x_all[:b].contiguous()
                gemv, shape, splits = qm.plan_untiled(b, n, d, g, sms=sms)
                want = qm.q8_matmul_pallas(x, w_q, w_s, g, compute_dtype=cdt,
                                           postscale=args.postscale)
                times = {}
                for route in tile_routes(n, g):
                    def call(route=route):
                        return qm.q8_untiled_launch(x, w_q, w_s, g, 512, cdt,
                                                    args.postscale, False,
                                                    *route)

                    got = call()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        print(f"untiled_routes: {preset} {label} b={b} "
                              f"route {route}: rows differ from the planned "
                              f"route's", file=sys.stderr)
                        bad += 1
                    times[route] = _device_ms(call, args.reps)
                fastest = min(times, key=times.get)
                planned = None if gemv else (shape, splits)
                print(json.dumps(dict(
                    model=preset, matrix=label, b=b, n=n, d=d,
                    compute=args.compute, postscale=args.postscale,
                    planned=planned, planned_ms=times.get(planned),
                    fastest=fastest, fastest_ms=times[fastest],
                    routes={f"{qm.UNTILED_TILE_SHAPES[s][0]}x{sp}": t
                            for (s, sp), t in times.items()})), flush=True)
            del w_q, w_s, x_all
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
