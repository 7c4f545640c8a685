"""Q8_0 matmuls: the CUDA kernels' wrappers and their plain versions.

Replaces qwen3_tpu/ops/pallas/q8_matmul.py::q8_q8_matmul_stacked (every layer
matmul) and ::q8_q8_matmul_tiled (the classifier) of mode "pallas",
::q8_matmul_stacked_fast / ::q8_matmul_tiled_fast of mode "pallas-fast",
::q8i8_matmul_stacked / ::q8i8_matmul_tiled of mode "pallas-int8", and
::q8_matmul_fused, the prologue-fused matmul of modes pallas and pallas-fast
under QWEN3_TPU_FUSE=1, and the untiled ::q8_q8_matmul_pallas and
::q8_matmul_pallas on contraction-leading weights, which only the tests
call. The kernels are `csrc/q8_matmul.cu`, `csrc/q8i8_matmul.cu`,
`csrc/q8_fused.cu` and `csrc/q8_untiled.cu`; see their notes for the
designs and the bounds.

Layout: the checkpoint's row-major weights, one output column per row,
  x_q int8 [..., n], x_s f32 [..., n/G]    (pallas-fast: x bf16 [..., n])
  w_q int8 [d, n],   w_s f32 [d, n/G]    (stacked: [L, d, n], [L, d, n/G])
  -> out f32 [..., d]
The TPU package's [J, n, td] tile repack (and the classifier's zero padding)
exists for the TPU's DMA blocks and has no counterpart here. The untiled
functions keep their JAX layout, w_q int8 [n, d] and w_s f32 [n/G, d].

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel launches,
one per call that reaches the kernel; its ROUTE_KEYS count the route
plan_fast gave each pallas-fast call (the tile kernel or the group split).
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.ops.activations import swiglu
from qwen3_tpu_torch.ops.cuda.flash_decode import decode_counters
from qwen3_tpu_torch.ops.q8 import quantize_act, round_bf16

LAUNCHES = {"stacked": 0, "tiled": 0, "stacked_fast": 0,
            "tiled_fast": 0, "stacked_int8": 0, "tiled_int8": 0,
            "fused": 0, "q8q8_pallas": 0, "pallas": 0,
            "fast_tile": 0, "fast_split": 0}
# keys of LAUNCHES that count a route, not a launch: the route plan_fast
# gave each q8_matmul_*_fast call (one of them a call)
ROUTE_KEYS = ("fast_tile", "fast_split")


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def pick_tile(n: int, quantum: int, cap: int) -> int:
    """Largest multiple of `quantum` dividing n, <= cap; the whole axis when
    none exists (qwen3_tpu/ops/pallas/q8_matmul.py::_pick_tile)."""
    t = min(cap, n)
    t -= t % quantum
    while t >= quantum:
        if n % t == 0:
            return t
        t -= quantum
    return n


def groups_per_tile(n: int, group_size: int) -> int:
    """Groups per k-tile of the fp32 accumulation: the TPU kernel's tk =
    _pick_tile(n, 8 * G, block_k=512) over G."""
    return pick_tile(n, 8 * group_size, 512) // group_size


# the Q8_0 x Q8_0 tile path (b > 1): rows a block by tile shape (0-2), its
# columns, and the blocks below which the k-tiles split over several blocks
TILE_ROWS = (16, 32, 64)
TILE_COLS = 64
SPLIT_BELOW = 132          # blocks: one H100 wave of one block an SM
SPLIT_TARGET = 264         # blocks a split grid aims at: two an SM


def plan_q8q8(b: int, n: int, d: int, group_size: int,
              sms: int = 132, block_k: int = 512) -> tuple[int, int]:
    """The tile path's grid for b > 1: (shape, splits). `shape` indexes
    TILE_ROWS: 16 rows up to b = 16, 32 up to b = 64 (two 32-row blocks
    beat one of 64 there), 64 past it (as fast as 128-row blocks at b = 512
    on an H100, with more blocks); `splits` is how many blocks share a
    tile's k-tiles (1: none) when the row and column blocks alone are fewer
    than SPLIT_BELOW (scaled to `sms`): at least as many as reach
    SPLIT_TARGET, or one a k-tile, each split holding the same number of
    k-tiles (the last fewer); the k-tiles are _pick_tile(n, 8 G, block_k)
    wide. Every choice computes each row alone in the same order, so the
    plan changes no bit."""
    shape = 0 if b <= 16 else 1 if b <= 64 else 2
    blocks = -(-d // TILE_COLS) * -(-b // TILE_ROWS[shape])
    nt = n // pick_tile(n, 8 * group_size, block_k)
    if blocks >= SPLIT_BELOW * sms // 132:
        return shape, 1
    want = -(-SPLIT_TARGET * sms // 132 // blocks)
    tps = max(1, nt // want)      # k-tiles a split: the kernel's even cut
    return shape, -(-nt // tps)


def q8q8_matmul_plain(x_q: torch.Tensor, x_s: torch.Tensor,
                      w_q: torch.Tensor, w_s: torch.Tensor,
                      group_size: int, block_k: int = 512) -> torch.Tensor:
    """The kernel's function in PyTorch, same arithmetic in the same order,
    with k-tiles tk = _pick_tile(n, 8 * G, block_k).

    Each group dot is computed as a float32 product of int8 values cast to
    float32, which is exact (every partial sum is an integer below 2^24).
    Never use torch.matmul on int8 tensors: it returns int8 and wraps."""
    *lead, n = x_q.shape
    d = w_q.shape[0]
    g = group_size
    ng = n // g
    xg = x_q.reshape(-1, ng, g).float()            # [b, ng, G]
    wg = w_q.reshape(d, ng, g).float()             # [d, ng, G]
    xs = x_s.reshape(-1, ng).float()
    ws = w_s.float()
    b = xg.shape[0]
    out = torch.zeros(b, d, dtype=torch.float32, device=x_q.device)
    gpt = pick_tile(n, 8 * g, block_k) // g
    for t0 in range(0, ng, gpt):
        dots = torch.bmm(xg[:, t0:t0 + gpt].transpose(0, 1),
                         wg[:, t0:t0 + gpt].permute(1, 2, 0))   # [gpt, b, d]
        acc = torch.zeros(b, d, dtype=torch.float32, device=x_q.device)
        for i in range(gpt):
            acc = acc + dots[i] * (xs[:, t0 + i, None] * ws[None, :, t0 + i])
        out = out + acc
    return out.reshape(*lead, d)


def _check(x, x_s, w_q, w_s, group_size, stacked: bool,
           x_dtype=torch.bfloat16, x_contiguous: bool = True):
    """What the kernels take: int8 activations x with f32 group scales
    x_s (Q8_0 x Q8_0), or activations x of `x_dtype` and no x_s (bf16 for
    pallas-fast, int8 for pallas-int8, f32 for the fused matmul); weights
    [d, n] (stacked [L, d, n]) with their scales; every tensor contiguous
    (x only when `x_contiguous`), 16-byte aligned and on x's CUDA device."""
    g = group_size
    if g < 16 or g > 512 or g & (g - 1):
        raise ValueError(f"group_size must be a power of two in [16, 512], "
                         f"got {g}")
    n = x.shape[-1]
    want_w = 3 if stacked else 2
    if w_q.dim() != want_w or w_s.dim() != want_w:
        raise ValueError(f"weights must be {want_w}-d, got {tuple(w_q.shape)}")
    if w_q.shape[-1] != n or n % g:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w_q.shape)}, G={g}")
    if tuple(w_s.shape) != tuple(w_q.shape[:-1]) + (n // g,):
        raise ValueError(f"weight scales {tuple(w_s.shape)} do not match "
                         f"{tuple(w_q.shape)} at G={g}")
    tensors = [("x", x, x_dtype)]
    if x_s is not None:
        if tuple(x_s.shape) != tuple(x.shape[:-1]) + (n // g,):
            raise ValueError(f"activation scales {tuple(x_s.shape)} do not "
                             f"match {tuple(x.shape)} at G={g}")
        tensors = [("x_q", x, torch.int8), ("x_s", x_s, torch.float32)]
    for name, t, dt in tensors + [("w_q", w_q, torch.int8),
                                  ("w_s", w_s, torch.float32)]:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if ((not t.is_contiguous() and (t is not x or x_contiguous))
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


_SMS: dict = {}


def _sm_count(device) -> int:
    """The card's SM count, read once per device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _launch(kind: str, x_q, x_s, w_q, w_s, layer, group_size):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _check(x_q, x_s, w_q, w_s, group_size, stacked=layer is not None)
    lib = load_library()
    *lead, n = x_q.shape
    d = w_q.shape[-2]
    b = x_q.numel() // n
    out = torch.empty(b, d, dtype=torch.float32, device=x_q.device)
    gpt = groups_per_tile(n, group_size)
    shape, splits, part = 0, 1, None      # b == 1 runs the GEMV
    if b > 1:
        sms = _sm_count(x_q.device)
        shape, splits = plan_q8q8(b, n, d, group_size, sms)
        if splits > 1:
            part = torch.empty(n // (gpt * group_size), b, d,
                               dtype=torch.float32, device=x_q.device)
    pp = None if part is None else part.data_ptr()
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    if layer is None:
        err = lib.q8q8_matmul(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(), pp, b, n, d,
                              group_size, gpt, shape, splits, stream)
    else:
        if not 0 <= layer < w_q.shape[0]:
            raise IndexError(f"layer {layer} outside [0, {w_q.shape[0]})")
        err = lib.q8q8_matmul_stacked(x_q.data_ptr(), x_s.data_ptr(),
                                      w_q.data_ptr(), w_s.data_ptr(), layer,
                                      out.data_ptr(), pp, b, n, d,
                                      group_size, gpt, shape, splits, stream)
    if err != 0:
        raise RuntimeError(f"q8q8 {kind} kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[kind] += 1
    return out.reshape(*lead, d)


def q8_q8_matmul_tiled(x_q: torch.Tensor, x_s: torch.Tensor,
                       w_q: torch.Tensor, w_s: torch.Tensor,
                       group_size: int) -> torch.Tensor:
    """int8 activations x one Q8_0 weight tensor [d, n] (the classifier)."""
    if x_q.device.type == "cpu":
        return q8q8_matmul_plain(x_q, x_s, w_q, w_s, group_size)
    return _launch("tiled", x_q, x_s, w_q, w_s, None, group_size)


def q8_q8_matmul_stacked(x_q: torch.Tensor, x_s: torch.Tensor,
                         w_q: torch.Tensor, w_s: torch.Tensor, layer: int,
                         group_size: int) -> torch.Tensor:
    """int8 activations x layer `layer` of stacked Q8_0 weights [L, d, n]."""
    if x_q.device.type == "cpu":
        return q8q8_matmul_plain(x_q, x_s, w_q[layer], w_s[layer], group_size)
    return _launch("stacked", x_q, x_s, w_q, w_s, int(layer), group_size)


# -- pallas-fast -----------------------------------------------------------

# the plain fast version's temporaries hold at most this many floats
_PLAIN_FAST_ELEMS = 1 << 24


def q8_fast_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                         w_s: torch.Tensor, group_size: int) -> torch.Tensor:
    """The fast kernel's function in PyTorch, same arithmetic in the same
    order: the weight dequantized as bf16(f32(w_q) * w_s), the activation
    rounded to bf16; per group, s = x_0 w_0 + x_1 w_1 + ... summed in k
    order from 0, then out = s_0 + s_1 + ... in group order from 0, all in
    fp32. A product of two bf16 values is exact in fp32, so each step rounds
    once, where the kernel's fmaf does. Columns go in chunks that keep the
    temporaries small."""
    *lead, n = x.shape
    d = w_q.shape[0]
    g = group_size
    ng = n // g
    xb = x.reshape(-1, n).to(torch.bfloat16).float().reshape(-1, 1, ng, g)
    b = xb.shape[0]
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_FAST_ELEMS // max(n, b * ng))
    for c0 in range(0, d, step):
        c1 = min(d, c0 + step)
        w = (w_q[c0:c1].float().reshape(c1 - c0, ng, g)
             * w_s[c0:c1, :, None].float()).to(torch.bfloat16).float()
        s = torch.zeros(b, c1 - c0, ng, dtype=torch.float32, device=x.device)
        for k in range(g):
            s = s + xb[..., k] * w[None, :, :, k]
        o = torch.zeros(b, c1 - c0, dtype=torch.float32, device=x.device)
        for i in range(ng):
            o = o + s[..., i]
        out[:, c0:c1] = o
    return out.reshape(*lead, d)


# the pallas-fast matmul's routes: the group split (q8_fast_split_kernel),
# which every b <= FAST_SPLIT_ROWS takes, or a shape of q8_fast_tile_kernel,
# (rows, columns, slices) a block: slices of 128 threads, each a group in
# turn, 8 x 8 outputs a thread at 128 columns, 8 x 4 at 64
FAST_SPLIT = -1
FAST_SPLIT_ROWS = 8
FAST_TILE_SHAPES = ((64, 128, 1), (64, 128, 2), (64, 64, 1), (64, 64, 4))
# A shape's FMAs an SM runs a microsecond (1e3 per microsecond is 1e9 per
# second), by how many of its blocks the busiest SM runs (1, 2, ...; past
# what an SM holds at once, 3, 1, 4 and 1, they run in waves; the last
# entry stands for more),
# and the group split's with a full card: tools.fast_routes on an NVIDIA
# H100 80GB HBM3 at 700 W, qwen3-4b's and qwen3-0.6b's layer matrices at b
# = 64-1024 (the fp32 pipe's peak is 253 a microsecond an SM)
FAST_TILE_RATES = ((110e3, 129e3, 148e3), (121e3,),
                   (82e3, 98e3, 112e3, 115e3, 120e3), (99e3,))
FAST_SPLIT_RATE = 55e3


def fast_tile_us(shape: int, b: int, n: int, d: int, sms: int = 132) -> float:
    """The tile kernel's time on `shape` as plan_fast reckons it: the
    busiest SM's blocks (the grid over `sms`, rounded up) times a block's
    rows x columns x n FMAs, at the rate of that many blocks an SM."""
    rows, cols, _ = FAST_TILE_SHAPES[shape]
    rates = FAST_TILE_RATES[shape]
    per_sm = -(-(-(-d // cols) * -(-b // rows)) // sms)
    return per_sm * rows * cols * n / rates[min(per_sm, len(rates)) - 1]


def plan_fast(b: int, n: int, d: int, group_size: int,
              sms: int = 132) -> int:
    """The fast matmul's route: FAST_SPLIT up to FAST_SPLIT_ROWS rows; above,
    the shape of FAST_TILE_SHAPES with the least fast_tile_us (on a tie the
    first), or FAST_SPLIT where the group split's b n d FMAs at
    FAST_SPLIT_RATE an SM take less. Every route computes each row alone in
    the same order, so the plan changes no bit."""
    del group_size
    if b <= FAST_SPLIT_ROWS:
        return FAST_SPLIT
    times = [fast_tile_us(s, b, n, d, sms)
             for s in range(len(FAST_TILE_SHAPES))]
    best = min(range(len(times)), key=times.__getitem__)
    split = b * n * d / (FAST_SPLIT_RATE * sms)
    return best if times[best] < split else FAST_SPLIT


def q8_fast_launch(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                   group_size: int, route: int | None = None,
                   layer: int | None = None) -> torch.Tensor:
    """The fast kernel on CUDA tensors against w_q [d, n] or layer `layer`
    of stacked weights [L, d, n], on plan_fast's route (`route` None, as
    the wrappers call it) or a given one: FAST_SPLIT or a shape of
    FAST_TILE_SHAPES, which chip_smoke.py, the card tests and
    tools.fast_routes force to hold and time them. Raises on a refused
    launch."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    x = x.to(torch.bfloat16).contiguous()
    _check(x, None, w_q, w_s, group_size, stacked=layer is not None)
    *lead, n = x.shape
    d = w_q.shape[-2]
    b = x.numel() // n
    if route is None:
        route = plan_fast(b, n, d, group_size, _sm_count(x.device))
    if route != FAST_SPLIT and route not in range(len(FAST_TILE_SHAPES)):
        raise ValueError(f"route must be FAST_SPLIT or a shape of "
                         f"FAST_TILE_SHAPES, got {route}")
    lib = load_library()
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if layer is None:
        err = lib.q8_fast_matmul(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                                 out.data_ptr(), b, n, d, group_size, route,
                                 stream)
    else:
        if not 0 <= layer < w_q.shape[0]:
            raise IndexError(f"layer {layer} outside [0, {w_q.shape[0]})")
        err = lib.q8_fast_matmul_stacked(x.data_ptr(), w_q.data_ptr(),
                                         w_s.data_ptr(), layer,
                                         out.data_ptr(), b, n, d, group_size,
                                         route, stream)
    if err != 0:
        raise RuntimeError(f"q8 fast kernel launch failed: CUDA error {err}")
    LAUNCHES["tiled_fast" if layer is None else "stacked_fast"] += 1
    LAUNCHES["fast_split" if route == FAST_SPLIT else "fast_tile"] += 1
    return out.reshape(*lead, d)


def q8_matmul_tiled_fast(x: torch.Tensor, w_q: torch.Tensor,
                         w_s: torch.Tensor, group_size: int) -> torch.Tensor:
    """Activations (rounded to bf16) x one Q8_0 weight tensor [d, n]
    dequantized to bf16 (the classifier of mode pallas-fast)."""
    if x.device.type == "cpu":
        return q8_fast_matmul_plain(x, w_q, w_s, group_size)
    return q8_fast_launch(x, w_q, w_s, group_size)


def q8_matmul_stacked_fast(x: torch.Tensor, w_q: torch.Tensor,
                           w_s: torch.Tensor, layer: int,
                           group_size: int) -> torch.Tensor:
    """Activations (rounded to bf16) x layer `layer` of stacked Q8_0
    weights [L, d, n] dequantized to bf16."""
    if x.device.type == "cpu":
        return q8_fast_matmul_plain(x, w_q[layer], w_s[layer], group_size)
    return q8_fast_launch(x, w_q, w_s, group_size, layer=int(layer))


# -- pallas-int8 -----------------------------------------------------------


def int8_tile(n: int, group_size: int) -> int:
    """The k-tile of mode pallas-int8: one activation scale per (row,
    k-tile) and one requantized weight scale per (k-tile, column). The TPU
    kernel's tk = _pick_tile(n, 8 * G, block_k) at the JAX package's default
    block_k 512 (its QWEN3_TPU_PALLAS_BK knob, which changes these tiles and
    so the numbers, is not ported)."""
    return pick_tile(n, 8 * group_size, 512)


def q8i8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                      group_size: int) -> torch.Tensor:
    """The int8 kernel's function in PyTorch, same arithmetic in the same
    order: x quantized per (row, k-tile) by quantize_act at group tk; per
    k-tile t and column c, s8 = the tile's largest group scale, ratio =
    w_s / s8 (a true division), w8 = sign(wf) * floor(|wf| + 0.5) with wf =
    f32(w_q) * ratio; then out = sum over the tiles in order of
    f32(dot(xq, w8)) * (xs * s8). The dots are products of integer-valued
    floats, exact in fp32 while tk * 127 * 128 < 2^24 (every qwen3 width:
    tk = 512), else taken in fp64 and rounded once, as the kernel's int32
    dot is. Columns go in chunks that keep the temporaries small."""
    *lead, n = x.shape
    d = w_q.shape[0]
    g = group_size
    tk = int8_tile(n, g)
    gpt = tk // g
    xq, xs = quantize_act(x.reshape(-1, n).float(), tk)
    b = xq.shape[0]
    dt = torch.float32 if tk * 127 * 128 < 1 << 24 else torch.float64
    xf = xq.to(dt)
    out = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_FAST_ELEMS // n)
    for c0 in range(0, d, step):
        c1 = min(d, c0 + step)
        ws = w_s[c0:c1].float().reshape(c1 - c0, n // tk, gpt)
        s8 = ws.amax(-1)                                       # [c, nt]
        wf = (w_q[c0:c1].float().reshape(c1 - c0, n // tk, gpt, g)
              * (ws / s8[..., None])[..., None])
        w8 = (torch.sign(wf) * torch.floor(torch.abs(wf) + 0.5)).reshape(
            c1 - c0, n)
        o = torch.zeros(b, c1 - c0, dtype=torch.float32, device=x.device)
        for t in range(n // tk):
            dot = (xf[:, t * tk:(t + 1) * tk]
                   @ w8[:, t * tk:(t + 1) * tk].to(dt).T).float()
            o = o + dot * (xs[:, t, None] * s8[None, :, t])
        out[:, c0:c1] = o
    return out.reshape(*lead, d)


def _launch_int8(kind: str, x, w_q, w_s, layer, group_size):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    *lead, n = x.shape
    tk = int8_tile(n, group_size)
    if tk % 64:
        raise ValueError(f"the int8 kernel takes k-tiles of a multiple of 64 "
                         f"bytes; n={n}, G={group_size} gives {tk}")
    xf = x.reshape(-1, n).float().contiguous()
    _check(xf, None, w_q, w_s, group_size, stacked=layer is not None,
           x_dtype=torch.float32)
    lib = load_library()
    d = w_q.shape[-2]
    b = xf.shape[0]
    # the kernel's quantized activations: xq int8 [b, n], then xs f32
    # [b, n / tk] at a 16-byte boundary
    off = -(-b * n // 16) * 16
    scratch = torch.empty(off + 4 * b * (n // tk), dtype=torch.uint8,
                          device=x.device)
    xq, xs = scratch.data_ptr(), scratch.data_ptr() + off
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if layer is None:
        err = lib.q8i8_matmul(xf.data_ptr(), xq, xs, w_q.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(), b, n, d,
                              group_size, tk, stream)
    else:
        if not 0 <= layer < w_q.shape[0]:
            raise IndexError(f"layer {layer} outside [0, {w_q.shape[0]})")
        err = lib.q8i8_matmul_stacked(xf.data_ptr(), xq, xs, w_q.data_ptr(),
                                      w_s.data_ptr(), layer, out.data_ptr(),
                                      b, n, d, group_size, tk, stream)
    if err != 0:
        raise RuntimeError(f"q8i8 {kind} kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[kind] += 1
    return out.reshape(*lead, d)


def q8i8_matmul_tiled(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                      group_size: int) -> torch.Tensor:
    """Float activations x one Q8_0 weight tensor [d, n] through the int8
    requantized product (the classifier of mode pallas-int8)."""
    if x.device.type == "cpu":
        return q8i8_matmul_plain(x, w_q, w_s, group_size)
    return _launch_int8("tiled_int8", x, w_q, w_s, None, group_size)


def q8i8_matmul_stacked(x: torch.Tensor, w_q: torch.Tensor,
                        w_s: torch.Tensor, layer: int,
                        group_size: int) -> torch.Tensor:
    """Float activations x layer `layer` of stacked Q8_0 weights [L, d, n]
    through the int8 requantized product (mode pallas-int8)."""
    if x.device.type == "cpu":
        return q8i8_matmul_plain(x, w_q[layer], w_s[layer], group_size)
    return _launch_int8("stacked_int8", x, w_q, w_s, int(layer), group_size)


# -- the prologue-fused matmul ---------------------------------------------

PROLOGUES = {"none": 0, "norm": 1, "swiglu": 2}


def fused_prologue(x: torch.Tensor, inv, nw, prologue: str) -> torch.Tensor:
    """The fused matmul's input h in fp32, by the port's unfused ops:
    "norm" nw * (x * inv) (rmsnorm with its row factor rms_inv(x) given),
    "swiglu" swiglu of x's halves [..., :n] and [..., n:], "none" x."""
    if prologue == "norm":
        return nw.float() * (x.float() * inv)
    if prologue == "swiglu":
        n = x.shape[-1] // 2
        return swiglu(x[..., :n].float(), x[..., n:].float())
    if prologue == "none":
        return x.float()
    raise ValueError(f"unknown prologue {prologue!r}")


def q8_fused_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                          w_s: torch.Tensor, group_size: int, inv=None,
                          nw=None, *, prologue: str = "none",
                          exact: bool = False) -> torch.Tensor:
    """The fused kernel's function in PyTorch: the port's unfused chain,
    fused_prologue -> quantize_act -> q8q8_matmul_plain (exact) or
    fused_prologue -> round_bf16 -> q8_fast_matmul_plain (fast)."""
    h = fused_prologue(x, inv, nw, prologue)
    if exact:
        xq, xs = quantize_act(h, group_size)
        return q8q8_matmul_plain(xq, xs, w_q, w_s, group_size)
    return q8_fast_matmul_plain(round_bf16(h), w_q, w_s, group_size)


def q8_matmul_fused(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                    group_size: int, inv=None, nw=None, *,
                    prologue: str = "none",
                    exact: bool = False) -> torch.Tensor:
    """Prologue-fused Q8_0 matmul against one weight tensor [d, n] (a
    layer's view of the stacked weights, or the classifier).

    x: f32 [..., n] raw activations, or with prologue="swiglu" the w13
    output [..., 2n] whose gate and up halves are read in place; inv: f32
    [..., 1] per-row rms_inv(x) and nw: f32 [n] norm weights (prologue
    "norm"). exact: Q8_0 x Q8_0 (mode pallas), else bf16 (pallas-fast).
    Returns f32 [..., d]."""
    if prologue not in PROLOGUES:
        raise ValueError(f"unknown prologue {prologue!r}")
    if prologue == "norm" and (inv is None or nw is None):
        raise ValueError("prologue 'norm' needs inv and nw")
    if x.device.type == "cpu":
        return q8_fused_matmul_plain(x, w_q, w_s, group_size, inv, nw,
                                     prologue=prologue, exact=exact)
    from qwen3_tpu_torch.ops.cuda.build import load_library

    *lead, last = x.shape
    n = last // 2 if prologue == "swiglu" else last
    xf = x.reshape(-1, last).float().contiguous()
    b = xf.shape[0]
    _check(xf[:, :n], None, w_q, w_s, group_size, stacked=False,
           x_dtype=torch.float32, x_contiguous=False)
    args = [None, None]
    if prologue == "norm":
        invf = inv.reshape(-1).float().contiguous()
        nwf = nw.float().contiguous()
        if nwf.data_ptr() % 16:      # the kernel reads nw 16 bytes at a time
            nwf = nwf.clone()
        if invf.shape != (b,) or nwf.shape != (n,):
            raise ValueError(f"inv {tuple(inv.shape)} / nw {tuple(nw.shape)} "
                             f"do not match x {tuple(x.shape)}")
        for name, t in (("inv", invf), ("nw", nwf)):
            if t.device != xf.device:
                raise ValueError(f"{name} must be on {xf.device}")
        args = [invf.data_ptr(), nwf.data_ptr()]
    lib = load_library()
    d = w_q.shape[-2]
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    gpt = groups_per_tile(n, group_size)
    # b > 1: the kernel makes the activations once into act (int8 and
    # scales, or bf16), then runs the unfused kernel on them
    shape, splits, part, act = 0, 1, None, [None, None]
    if b > 1:
        if exact:
            act = [torch.empty(b, n, dtype=torch.int8, device=x.device),
                   torch.empty(b, n // group_size, dtype=torch.float32,
                               device=x.device)]
            shape, splits = plan_q8q8(b, n, d, group_size,
                                      _sm_count(x.device))
            if splits > 1:
                part = torch.empty(n // (gpt * group_size), b, d,
                                   dtype=torch.float32, device=x.device)
        else:
            act = [torch.empty(b, n, dtype=torch.bfloat16, device=x.device),
                   None]
            shape = plan_fast(b, n, d, group_size, _sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [None if t is None else t.data_ptr() for t in (part, *act)]
    err = lib.q8_fused_matmul(xf.data_ptr(), *args, w_q.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(), *ptrs, b, n, d,
                              group_size, gpt, shape, splits,
                              PROLOGUES[prologue], int(exact), stream)
    if err != 0:
        raise RuntimeError(f"q8 fused kernel launch failed: CUDA error {err}")
    LAUNCHES["fused"] += 1
    return out.reshape(*lead, d)


# -- the untiled matmuls on contraction-leading weights --------------------


def q8_q8_matmul_pallas_plain(x_q: torch.Tensor, x_s: torch.Tensor,
                              w_q: torch.Tensor, w_s: torch.Tensor,
                              group_size: int,
                              block_k: int = 512) -> torch.Tensor:
    """The untiled exact kernel's function in PyTorch: q8q8_matmul_plain on
    the [n, d] weights' transpose, the same arithmetic in the same order."""
    return q8q8_matmul_plain(x_q, x_s, w_q.T, w_s.T, group_size, block_k)


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def q8_matmul_pallas_plain(x: torch.Tensor, w_q: torch.Tensor,
                           w_s: torch.Tensor, group_size: int,
                           block_k: int = 512,
                           compute_dtype=torch.float32,
                           postscale: bool = False) -> torch.Tensor:
    """The untiled dequant kernel's function in PyTorch, per k-tile tk =
    _pick_tile(n, 8 * G, block_k): x rounded to `compute_dtype`; prescale
    dots it with the tile's weights dequantized as f32(w_q) * w_s and
    rounded to `compute_dtype`, postscale dots each group with f32(w_q)
    and scales the group's dot by w_s after it; each tile's sum is added to
    out in k order. The dots are fp32 products of values held in fp32
    (TF32 off; products of bf16 values are exact), summed in torch.matmul's
    order."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    *lead, n = x.shape
    d = w_q.shape[1]
    g = group_size
    tk = pick_tile(n, 8 * g, block_k)
    xc = x.reshape(-1, n).to(compute_dtype).float()
    out = torch.zeros(xc.shape[0], d, dtype=torch.float32, device=x.device)
    for k0 in range(0, n, tk):
        if postscale:
            acc = torch.zeros_like(out)
            for i in range(k0 // g, (k0 + tk) // g):
                dot = xc[:, i * g:(i + 1) * g] @ w_q[i * g:(i + 1) * g].float()
                acc = acc + dot * w_s[i].float()[None, :]
            out = out + acc
        else:
            w = (w_q[k0:k0 + tk].float().reshape(tk // g, g, d)
                 * w_s[k0 // g:(k0 + tk) // g].float()[:, None, :])
            w = w.reshape(tk, d).to(compute_dtype).float()
            out = out + xc[:, k0:k0 + tk] @ w
    return out.reshape(*lead, d)


def _check_untiled(x, x_s, w_q, w_s, group_size, x_dtype):
    """What the untiled kernels take: x of `x_dtype` [..., n] (and, for the
    exact kernel, f32 group scales x_s), weights w_q int8 [n, d] and w_s
    f32 [n/G, d] with d % 4 == 0; every tensor contiguous, 16-byte aligned
    and on x's CUDA device."""
    g = group_size
    if g < 16 or g > 512 or g & (g - 1):
        raise ValueError(f"group_size must be a power of two in [16, 512], "
                         f"got {g}")
    n = x.shape[-1]
    if w_q.dim() != 2 or w_q.shape[0] != n or n % g:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w_q.shape)}, G={g}")
    d = w_q.shape[1]
    if d % 4:
        raise ValueError(f"the untiled kernels take d % 4 == 0, got d={d}")
    if tuple(w_s.shape) != (n // g, d):
        raise ValueError(f"weight scales {tuple(w_s.shape)} do not match "
                         f"{tuple(w_q.shape)} at G={g}")
    tensors = [("x", x, x_dtype), ("w_q", w_q, torch.int8),
               ("w_s", w_s, torch.float32)]
    if x_s is not None:
        if tuple(x_s.shape) != tuple(x.shape[:-1]) + (n // g,):
            raise ValueError(f"activation scales {tuple(x_s.shape)} do not "
                             f"match {tuple(x.shape)} at G={g}")
        tensors.append(("x_s", x_s, torch.float32))
    for name, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


UNTILED_GEMV_ROWS = 8      # q8_matmul_pallas runs its GEMV up to this b
# q8_matmul_pallas's tile kernel past it: plan_untiled's shapes, (rows,
# columns) a block of 2 x rows threads, 8 x 8 outputs a thread; its k-tiles
# split only where the unsplit grid holds fewer than UNTILED_SPLIT_WARPS
# warps (16 an SM on 132 SMs: two 128-row blocks), and a grid under
# UNTILED_MIN_WARPS (4 an SM) is short of warps. Chosen by chip_smoke.py's
# forced routes at qwen3-0.6b's b = 512 layer matrices on an H100 (f32
# prescale, us): wqkv 124.0 (128 rows, 2 splits; unsplit 132.1), wo 75.9
# (128 rows, 4; 64 rows, 2 splits: 92.4), w13 187.4 (128 rows, 2; unsplit
# 221.2), w2 108.5 (64 rows, 6; 128 rows, 6: 126.8); blocks of 64 x 64
# (8 x 4 a thread) were slower in prescale on all four
UNTILED_TILE_SHAPES = ((64, 128), (128, 128))
UNTILED_SPLIT_WARPS = 16 * 132
UNTILED_MIN_WARPS = 4 * 132
# q8_q8_matmul_pallas runs its GEMV up to this b (the crossover with the
# MMA tile path measured by chip_smoke.py on an H100: the GEMV faster on
# every qwen3-0.6b layer matrix at b <= 4, even with it summed over a token
# at b = 8), while its group terms, R x n / G with R = b rounded up to 1, 2
# or 4, are at most UNTILED_GEMV_MAX_TERMS (they sit in shared memory)
UNTILED_Q8Q8_GEMV_ROWS = 4
UNTILED_GEMV_MAX_TERMS = 1024
# ... unless the MMA tile path's 16-row blocks number at least this many on
# 132 SMs (scaled to the card's count): then the tile path fills the card
# unsplit, in one launch, and streams the weights faster than the GEMV,
# whose 32-column blocks run in waves. It is at least SPLIT_TARGET, so that
# plan_q8q8 gives the tile path no k-split (a second launch) here. Measured
# by chip_smoke.py at b = 1 on an H100 (GEMV / tile path, us): below it
# qwen3-0.6b's four layer matrices (1024-6144 columns) 8.1-10.5 / 12.6-13.3
# and qwen3-4b's wo (2560 columns) 11.9 / 13.7; above it qwen3-4b's w13
# (19456 columns, 304 blocks) 38.0 / 33.5 and qwen3-0.6b's classifier
# (151936) 84.4 / 75.1. Below it the GEMV keeps b = 1 at one launch where
# the tile path, split, is faster: qwen3-4b's wqkv (6144 columns, 96
# blocks) 15.9 / 14.9 and w2 (2560 columns, 9728 k) 22.9 / 20.5.
UNTILED_Q8Q8_TILE_BLOCKS = 264


def untiled_gemv_fits(b: int, n: int, group_size: int) -> bool:
    """Whether q8_q8_matmul_pallas's GEMV takes b rows of n."""
    rows = 1 << max(0, (b - 1).bit_length())
    return (b <= UNTILED_Q8Q8_GEMV_ROWS
            and rows * (n // group_size) <= UNTILED_GEMV_MAX_TERMS)


def plan_untiled(b: int, n: int, d: int, group_size: int, block_k: int = 512,
                 sms: int = 132) -> tuple[bool, int, int]:
    """q8_matmul_pallas's route: (gemv, shape, splits). A call of at most
    UNTILED_GEMV_ROWS rows runs the GEMV, one launch whose warps take the
    k-tiles (shape 0, splits 1). A larger one runs the tile kernel on
    UNTILED_TILE_SHAPES[shape] (128-row blocks only past 64 rows), its
    k-tiles split evenly over `splits` blocks (a divisor of the tile count,
    combined in order in the same launch), splitting only where the
    unsplit grid holds fewer than UNTILED_SPLIT_WARPS warps. Of those grids
    it takes the one whose busiest SM has the fewest FMAs to run (its
    blocks, rounded up, times each block's rows x columns x k-rows),
    leaving out grids under UNTILED_MIN_WARPS warps where others reach it;
    on a tie, more warps, then more rows a block. The thresholds scale with
    `sms`. Every route runs each row's chains in the same order, so the
    plan changes no bit."""
    if b <= UNTILED_GEMV_ROWS:
        return True, 0, 1
    nt = n // pick_tile(n, 8 * group_size, block_k)
    best = None
    for shape, (rows, cols) in enumerate(UNTILED_TILE_SHAPES):
        if rows > 64 >= b:
            continue             # one 64-row block holds every row
        grid = -(-d // cols) * -(-b // rows)
        for splits in range(1, nt + 1):
            if nt % splits or (splits > 1 and grid * rows // 16
                               >= UNTILED_SPLIT_WARPS * sms // 132):
                continue
            warps = grid * splits * rows // 16
            key = (warps < UNTILED_MIN_WARPS * sms // 132,
                   -(-grid * splits // sms) * rows * cols * (n // splits),
                   -warps, -rows)
            if best is None or key < best[0]:
                best = (key, shape, splits)
    return False, best[1], best[2]


def plan_untiled_q8q8(b: int, n: int, d: int, group_size: int,
                      block_k: int = 512,
                      sms: int = 132) -> tuple[bool, int, int]:
    """q8_q8_matmul_pallas's route: (gemv, shape, splits). Up to
    UNTILED_Q8Q8_GEMV_ROWS rows (where untiled_gemv_fits) the GEMV, one
    launch whose lanes run over columns (shape 0, splits 1), unless the
    tile path's blocks reach UNTILED_Q8Q8_TILE_BLOCKS (scaled to `sms`):
    then the tile path, one launch, unsplit. Above, the MMA tile path on
    plan_q8q8's grid for these k-tiles. Every route gives the same bits."""
    tile_blocks = -(-d // TILE_COLS) * -(-b // TILE_ROWS[0])
    if (untiled_gemv_fits(b, n, group_size)
            and tile_blocks < UNTILED_Q8Q8_TILE_BLOCKS * sms // 132):
        return True, 0, 1
    shape, splits = plan_q8q8(b, n, d, group_size, sms, block_k)
    return False, shape, splits


def q8_q8_untiled_launch(x_q: torch.Tensor, x_s: torch.Tensor,
                         w_q: torch.Tensor, w_s: torch.Tensor,
                         group_size: int, block_k: int, gemv: bool,
                         shape: int = 0, splits: int = 1) -> torch.Tensor:
    """The untiled exact kernel on CUDA tensors, on a given route: the GEMV
    (where untiled_gemv_fits), or the tile path with plan_q8q8's `shape` and
    `splits`. q8_q8_matmul_pallas takes plan_untiled_q8q8's route;
    chip_smoke.py and the card tests force the others to hold and time
    them. Raises on a refused launch."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _check_untiled(x_q, x_s, w_q, w_s, group_size, torch.int8)
    *lead, n = x_q.shape
    d = w_q.shape[1]
    b = x_q.numel() // n
    gpt = pick_tile(n, 8 * group_size, block_k) // group_size
    nt = n // group_size // gpt
    if gemv and not untiled_gemv_fits(b, n, group_size):
        raise ValueError(f"the GEMV takes at most {UNTILED_Q8Q8_GEMV_ROWS} "
                         f"rows and {UNTILED_GEMV_MAX_TERMS} group terms, "
                         f"got b={b}, n={n}, G={group_size}")
    out = torch.empty(b, d, dtype=torch.float32, device=x_q.device)
    part = None
    if not gemv and splits > 1:
        part = torch.empty(nt, b, d, dtype=torch.float32, device=x_q.device)
    err = load_library().q8q8_untiled(
        x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, n, d,
        group_size, gpt, int(gemv), shape, splits,
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q8q8_pallas kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["q8q8_pallas"] += 1
    return out.reshape(*lead, d)


def q8_q8_matmul_pallas(x_q: torch.Tensor, x_s: torch.Tensor,
                        w_q: torch.Tensor, w_s: torch.Tensor,
                        group_size: int, block_k: int = 512,
                        block_d: int = 1024) -> torch.Tensor:
    """int8 activations (x_q [..., n], x_s f32 [..., n/G]) x Q8_0 weights
    w_q int8 [n, d], w_s f32 [n/G, d] -> f32 [..., d]: exact int32 group
    dots, then the fp32 scale-and-sum in group and k-tile order. block_d
    sizes the TPU's column tiles only; columns are independent, so it
    changes no number."""
    del block_d
    if x_q.device.type == "cpu":
        return q8_q8_matmul_pallas_plain(x_q, x_s, w_q, w_s, group_size,
                                         block_k)
    n = x_q.shape[-1]
    gemv, shape, splits = plan_untiled_q8q8(
        x_q.numel() // max(n, 1), n, w_q.shape[-1], group_size, block_k,
        _sm_count(x_q.device))
    return q8_q8_untiled_launch(x_q, x_s, w_q, w_s, group_size, block_k,
                                gemv, shape, splits)


def q8_untiled_launch(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                      group_size: int, block_k: int, compute_dtype,
                      postscale: bool, gemv: bool, shape: int = 0,
                      splits: int = 1) -> torch.Tensor:
    """The untiled dequant kernel on CUDA tensors, on a given route: the GEMV
    (b <= UNTILED_GEMV_ROWS), or the tile kernel on
    UNTILED_TILE_SHAPES[shape] with its k-tiles over `splits` blocks (a
    divisor of the tile count). q8_matmul_pallas takes plan_untiled's
    route; chip_smoke.py and the card tests force the others to hold and
    time them. Raises on a refused launch."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    if x.dtype not in COMPUTE_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    xf = x.float().contiguous()
    _check_untiled(xf, None, w_q, w_s, group_size, torch.float32)
    *lead, n = x.shape
    d = w_q.shape[1]
    b = xf.numel() // n
    gpt = pick_tile(n, 8 * group_size, block_k) // group_size
    nt = n // group_size // gpt
    if gemv and b > UNTILED_GEMV_ROWS:
        raise ValueError(f"the GEMV takes at most {UNTILED_GEMV_ROWS} rows, "
                         f"got b={b}")
    if not gemv and (shape not in range(len(UNTILED_TILE_SHAPES))
                     or splits < 1 or nt % splits):
        raise ValueError(f"the tile kernel takes a shape of "
                         f"UNTILED_TILE_SHAPES and a split "
                         f"dividing its {nt} k-tiles, got shape={shape}, "
                         f"splits={splits}")
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    part = counters = None
    if not gemv and splits > 1:
        rows, cols = UNTILED_TILE_SHAPES[shape]
        part = torch.empty(nt, b, d, dtype=torch.float32, device=x.device)
        # the decode kernels' completion counters, one a (row, column)
        # block: zeros on this stream, left at zero by the kernel
        counters = decode_counters(x.device, -(-d // cols) * -(-b // rows))
    err = load_library().q8_untiled(
        xf.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), b, n, d,
        group_size, gpt, int(compute_dtype == torch.bfloat16),
        int(postscale), int(gemv), shape, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pallas kernel launch failed: CUDA error {err}")
    LAUNCHES["pallas"] += 1
    return out.reshape(*lead, d)


def q8_matmul_pallas(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                     group_size: int, block_k: int = 512, block_d: int = 512,
                     compute_dtype=torch.float32,
                     postscale: bool = False) -> torch.Tensor:
    """x [..., n] (f32 or bf16) @ dequant(w_q int8 [n, d], w_s f32 [n/G,
    d]) -> f32 [..., d], in `compute_dtype` f32 (true fp32) or bf16, the
    scales applied to the weight tile before the dot or, with `postscale`,
    to each group's dot after it. block_d as for q8_q8_matmul_pallas."""
    del block_d
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    if x.device.type == "cpu":
        return q8_matmul_pallas_plain(x, w_q, w_s, group_size, block_k,
                                      compute_dtype, postscale)
    n = x.shape[-1]
    gemv, shape, splits = plan_untiled(
        x.numel() // max(n, 1), n, w_q.shape[-1], group_size, block_k,
        _sm_count(x.device))
    return q8_untiled_launch(x, w_q, w_s, group_size, block_k, compute_dtype,
                             postscale, gemv, shape, splits)
