"""Time every route of the pallas-fast matmul past b = 8 at a preset's
layer matrices, to hold plan_fast's choice against the fastest route.

    python -m qwen3_tpu_torch.tools.fast_routes \
        [--models qwen3-0.6b,qwen3-4b] [--batches 64,128,512] [--reps 10] \
        [--seed 0]

For each layer matrix of each preset in the checkpoint's [d, n] layout
(wqkv, wo, w13, w2) and each b, every route (the group split and each shape
of FAST_TILE_SHAPES) is forced through q8_fast_launch on random weights made
from --seed, its rows held bit-equal to the planned route's, and timed with
CUDA events (the median of --reps runs, each queued behind a device spin so
the host's launch does not show). Prints one JSON line per (matrix, b): the
planned route and its time, the fastest route and its time, every route's
time and the fp32 FMAs' floor; exits 1 if a route's rows differ. Runs on
the card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from qwen3_tpu_torch.ops.cuda import q8_matmul as qm
from qwen3_tpu_torch.tools.untiled_routes import _device_ms, layer_matrices

FP32_OPS_PER_S = 67e12     # H100 SXM fp32 peak outside the tensor cores


def routes() -> list[int]:
    """Every route the fast kernel takes past b = 8."""
    return [qm.FAST_SPLIT, *range(len(qm.FAST_TILE_SHAPES))]


def route_name(route: int) -> str:
    if route == qm.FAST_SPLIT:
        return "split"
    rows, cols, slices = qm.FAST_TILE_SHAPES[route]
    return f"{rows}x{cols}/{slices}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m qwen3_tpu_torch.tools.fast_routes")
    p.add_argument("--models", default="qwen3-0.6b,qwen3-4b")
    p.add_argument("--batches", default="64,128,512")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fast_routes: needs a CUDA device", file=sys.stderr)
        return 2
    batches = [int(b) for b in args.batches.split(",")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = 0
    for preset in args.models.split(","):
        for label, n, d, g in layer_matrices(preset):
            w_q = torch.randint(-127, 128, (d, n), dtype=torch.int8,
                                device="cuda", generator=gen)
            w_s = 0.02 / 127 * (0.5 + torch.rand(d, n // g, device="cuda",
                                                 generator=gen))
            x_all = torch.randn(max(batches), n, device="cuda",
                                generator=gen).to(torch.bfloat16)
            for b in batches:
                x = x_all[:b].contiguous()
                planned = qm.plan_fast(b, n, d, g, sms=sms)
                want = qm.q8_matmul_tiled_fast(x, w_q, w_s, g)
                times = {}
                for route in routes():
                    def call(route=route):
                        return qm.q8_fast_launch(x, w_q, w_s, g, route)

                    got = call()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        print(f"fast_routes: {preset} {label} b={b} route "
                              f"{route_name(route)}: rows differ from the "
                              f"planned route's", file=sys.stderr)
                        bad += 1
                    times[route] = _device_ms(call, args.reps)
                fastest = min(times, key=times.get)
                print(json.dumps(dict(
                    model=preset, matrix=label, b=b, n=n, d=d,
                    planned=route_name(planned), planned_ms=times[planned],
                    fastest=route_name(fastest), fastest_ms=times[fastest],
                    fma_floor_ms=1e3 * 2 * b * n * d / FP32_OPS_PER_S,
                    routes={route_name(r): t for r, t in times.items()})),
                    flush=True)
            del w_q, w_s, x_all
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
