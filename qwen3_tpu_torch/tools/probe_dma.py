"""Probe how fast the card streams the weights: the Q8_0 matmul the CLI
decodes with against pure-read kernels on the same tensor.

    python -m qwen3_tpu_torch.tools.probe_dma [--device cuda]

The counterpart of tools/probe_dma.py. It generates qwen3-4b's pallas-mode
parameters on the device (io/device_synth.py), takes w13, the largest
per-layer tensor ([36, 19456, 2560] int8, 49.8 MB a layer), and times
N_ITERS calls of each kernel, call i reading layer i % 36, so that a layer
never sits in the 50 MB L2 from the call before. Rows:

- `q8q8 stacked matmul`: ops/cuda/q8_matmul.py::q8_q8_matmul_stacked at
  b = 1 on x = 0.01 quantized (the CLI's decode GEMV);
- `pure-read same walk`: pure_read_stacked, the GEMV's grid and loads with
  a checksum for a body;
- `manual DMA 2/3/4-buffer`: pure_read_manual, the same bytes through an
  n_buf-slot ring of bulk async copies a block.

Each row prints ms a layer and GB/s (the layer's weight bytes over that
time). On the card the calls are timed with CUDA events, queued behind a
device spin that outlasts the host's launches, so the host does not set the
pace; on the CPU (--device cpu, the plain versions) with the host clock.

Both pure-read kernels return the JAX probes' checksum, int32 [8, td], every
row the sum over the layer's [tk, td] tiles of each tile's first 8 k-rows,
with td = _pick_tile(d, 128, 1024) and tk = _pick_tile(n, 512, block_k): the
JAX tile (jj, kk) is rows jj * td .. + td - 1 of the port's [d, n] layer,
bytes kk * tk .. + tk - 1. `pure_read_plain` is the same sum in PyTorch. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from qwen3_tpu_torch.ops.cuda.q8_matmul import pick_tile

LAUNCHES = {"pure_read_stacked": 0, "pure_read_manual": 0}
N_BUFS = (2, 3, 4)
PRESET = "qwen3-4b"
N_ITERS = 64
SPIN_CYCLES = 20_000_000       # the first device spin before a timed loop


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def probe_tiles(d: int, n: int, block_k: int = 512) -> tuple[int, int]:
    """(td, tk) of the JAX probes: td = _pick_tile(d, 128, 1024), the
    repack's column tile, and tk = _pick_tile(n, 512, block_k)."""
    td, tk = pick_tile(d, 128, 1024), pick_tile(n, 512, block_k)
    if d % td or n % tk:
        raise ValueError(f"tiles ({td}, {tk}) do not divide [{d}, {n}]")
    return td, tk


def pure_read_plain(w: torch.Tensor, layer: int,
                    block_k: int = 512) -> torch.Tensor:
    """The pure-read checksum of layer `layer` of w int8 [L, d, n]: int32
    [8, td], every row sum_{jj, kk, i < 8} w[layer, jj * td + t, kk * tk
    + i]."""
    _, d, n = w.shape
    td, tk = probe_tiles(d, n, block_k)
    heads = w[layer].reshape(d, n // tk, tk)[:, :, :8].to(torch.int32)
    col = heads.sum((1, 2)).reshape(d // td, td).sum(0)
    return col.to(torch.int32).expand(8, td).contiguous()


def _check(w: torch.Tensor, layer: int, block_k: int):
    if w.dtype != torch.int8 or w.dim() != 3:
        raise ValueError(f"w must be int8 [L, d, n], got {w.dtype} "
                         f"{tuple(w.shape)}")
    L, d, n = w.shape
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    if not w.is_contiguous() or w.data_ptr() % 16 or n % 16:
        raise ValueError("w must be contiguous and 16-byte aligned, n % 16 "
                         "== 0")
    return (d, n) + probe_tiles(d, n, block_k)


def launch_pure_read(kind: str, w: torch.Tensor, layer: int,
                     out: torch.Tensor, n_buf: int = 2,
                     block_k: int = 512) -> torch.Tensor:
    """Add layer `layer`'s checksum into `out` (int32 [8, td] on w's card,
    zeroed by the caller) with the `kind` kernel ("pure_read_stacked" or
    "pure_read_manual"); the wrappers call this on a fresh zeroed out, the
    probe on buffers zeroed before its timed loop."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    d, n, td, tk = _check(w, layer, block_k)
    if w.device.type != "cuda" or out.device != w.device:
        raise ValueError(f"w and out must be on one CUDA device, got "
                         f"{w.device} and {out.device}")
    if out.dtype != torch.int32 or tuple(out.shape) != (8, td) or \
            not out.is_contiguous():
        raise ValueError(f"out must be contiguous int32 [8, {td}]")
    lib = load_library()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    if kind == "pure_read_stacked":
        if tk % 512 and tk != n:
            raise ValueError(f"the GEMV walk takes tk % 512 == 0 or tk == n, "
                             f"got tk={tk}")
        err = lib.pure_read_stacked(w.data_ptr(), layer, out.data_ptr(), d, n,
                                    td, tk, 0, stream)
    elif kind == "pure_read_manual":
        if n_buf not in N_BUFS:
            raise ValueError(f"n_buf must be one of {N_BUFS}, got {n_buf}")
        if td % 64 or td > 1024 or tk % 16 or 64 * tk > 32768:
            raise ValueError(f"the ring takes td % 64 == 0, td <= 1024, "
                             f"tk % 16 == 0 and tk <= 512, got td={td}, "
                             f"tk={tk}")
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        err = lib.pure_read_manual(w.data_ptr(), layer, out.data_ptr(), d, n,
                                   td, tk, n_buf, sms, stream)
    else:
        raise ValueError(f"unknown pure-read kernel {kind!r}")
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    LAUNCHES[kind] += 1
    return out


def _fresh_out(w: torch.Tensor, block_k: int) -> torch.Tensor:
    td, _ = probe_tiles(w.shape[1], w.shape[2], block_k)
    return torch.zeros(8, td, dtype=torch.int32, device=w.device)


def pure_read_stacked(w: torch.Tensor, layer: int,
                      block_k: int = 512) -> torch.Tensor:
    """The checksum of layer `layer` of w int8 [L, d, n], read by the Q8_0
    GEMV's walk."""
    if w.device.type == "cpu":
        return pure_read_plain(w, layer, block_k)
    return launch_pure_read("pure_read_stacked", w, int(layer),
                            _fresh_out(w, block_k), block_k=block_k)


def pure_read_manual(w: torch.Tensor, layer: int, n_buf: int,
                     block_k: int = 512) -> torch.Tensor:
    """The same checksum, streamed through n_buf-slot (2, 3 or 4) rings of
    bulk async copies, one persistent block an SM."""
    if n_buf not in N_BUFS:
        raise ValueError(f"n_buf must be one of {N_BUFS}, got {n_buf}")
    if w.device.type == "cpu":
        return pure_read_plain(w, layer, block_k)
    return launch_pure_read("pure_read_manual", w, int(layer),
                            _fresh_out(w, block_k), n_buf, block_k)


def time_calls(fn, device: torch.device, iters: int = N_ITERS) -> float:
    """Milliseconds a call of fn(i), over `iters` calls. On the card: CUDA
    events around the calls, queued behind a device spin that is doubled
    until it outlasts the host's launches."""
    fn(0)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    while True:
        spin_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin_start.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if spin_start.elapsed_time(start) > host_ms:
            return start.elapsed_time(end) / iters
        cycles *= 2


def run_probe(device: torch.device, iters: int = N_ITERS):
    """The probe's rows [(label, ms a layer, GB/s)] and the w13 weights,
    with their per-layer bytes."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.device_synth import synth_device_params
    from qwen3_tpu_torch.ops.cuda.q8_matmul import q8_q8_matmul_stacked
    from qwen3_tpu_torch.ops.q8 import quantize_act

    cfg = PRESETS[PRESET].with_seq_len(512)
    params = synth_device_params(cfg, 512, seed=0, device=device)
    w_q, w_s = params["w13_q"], params["w13_s"]
    L, d, n = w_q.shape
    nbytes = w_q.numel() // L
    td, _ = probe_tiles(d, n)
    x = torch.full((1, n), 0.01, dtype=torch.float32, device=device)
    xq, xs = quantize_act(x, cfg.group_size)

    def matmul(i):
        q8_q8_matmul_stacked(xq, xs, w_q, w_s, i % L, cfg.group_size)

    def reader(kind, n_buf=2):
        if device.type != "cuda":
            return lambda i: pure_read_plain(w_q, i % L)
        # zeroed outputs made before the timed calls: each call is one
        # kernel launch, as the matmul's is
        outs = torch.zeros(iters, 8, td, dtype=torch.int32, device=device)
        return lambda i: launch_pure_read(kind, w_q, i % L, outs[i % iters],
                                          n_buf)

    rows = []
    for label, fn in (("q8q8 stacked matmul", matmul),
                      ("pure-read same walk", reader("pure_read_stacked")),
                      *((f"manual DMA {k}-buffer",
                         reader("pure_read_manual", k)) for k in N_BUFS)):
        ms = time_calls(fn, device, iters)
        rows.append((label, ms, nbytes / (ms * 1e-3) / 1e9))
    return rows, w_q, nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qwen3_tpu_torch.tools."
                                      "probe_dma")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    from qwen3_tpu_torch.models.qwen3 import resolve_device

    device = resolve_device(args.device)
    rows, w_q, nbytes = run_probe(device, N_ITERS)
    print(f"w13_q per-layer bytes: {nbytes / 1e6:.1f} MB", flush=True)
    for label, ms, gbs in rows:
        print(f"{label:24s} {ms:7.3f} ms/layer  {gbs:6.1f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
