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
one per call that reaches the kernel.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.ops.activations import swiglu
from qwen3_tpu_torch.ops.q8 import quantize_act, round_bf16

LAUNCHES = {"stacked": 0, "tiled": 0, "stacked_fast": 0,
            "tiled_fast": 0, "stacked_int8": 0, "tiled_int8": 0,
            "fused": 0, "q8q8_pallas": 0, "pallas": 0}


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


def _launch(kind: str, x_q, x_s, w_q, w_s, layer, group_size):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _check(x_q, x_s, w_q, w_s, group_size, stacked=layer is not None)
    lib = load_library()
    *lead, n = x_q.shape
    d = w_q.shape[-2]
    b = x_q.numel() // n
    out = torch.empty(b, d, dtype=torch.float32, device=x_q.device)
    gpt = groups_per_tile(n, group_size)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    if layer is None:
        err = lib.q8q8_matmul(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(), b, n, d,
                              group_size, gpt, stream)
    else:
        if not 0 <= layer < w_q.shape[0]:
            raise IndexError(f"layer {layer} outside [0, {w_q.shape[0]})")
        err = lib.q8q8_matmul_stacked(x_q.data_ptr(), x_s.data_ptr(),
                                      w_q.data_ptr(), w_s.data_ptr(), layer,
                                      out.data_ptr(), b, n, d, group_size,
                                      gpt, stream)
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


def _launch_fast(kind: str, x, w_q, w_s, layer, group_size):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    x = x.to(torch.bfloat16).contiguous()
    _check(x, None, w_q, w_s, group_size, stacked=layer is not None)
    lib = load_library()
    *lead, n = x.shape
    d = w_q.shape[-2]
    b = x.numel() // n
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if layer is None:
        err = lib.q8_fast_matmul(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                                 out.data_ptr(), b, n, d, group_size, stream)
    else:
        if not 0 <= layer < w_q.shape[0]:
            raise IndexError(f"layer {layer} outside [0, {w_q.shape[0]})")
        err = lib.q8_fast_matmul_stacked(x.data_ptr(), w_q.data_ptr(),
                                         w_s.data_ptr(), layer,
                                         out.data_ptr(), b, n, d, group_size,
                                         stream)
    if err != 0:
        raise RuntimeError(f"q8 fast {kind} kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[kind] += 1
    return out.reshape(*lead, d)


def q8_matmul_tiled_fast(x: torch.Tensor, w_q: torch.Tensor,
                         w_s: torch.Tensor, group_size: int) -> torch.Tensor:
    """Activations (rounded to bf16) x one Q8_0 weight tensor [d, n]
    dequantized to bf16 (the classifier of mode pallas-fast)."""
    if x.device.type == "cpu":
        return q8_fast_matmul_plain(x, w_q, w_s, group_size)
    return _launch_fast("tiled_fast", x, w_q, w_s, None, group_size)


def q8_matmul_stacked_fast(x: torch.Tensor, w_q: torch.Tensor,
                           w_s: torch.Tensor, layer: int,
                           group_size: int) -> torch.Tensor:
    """Activations (rounded to bf16) x layer `layer` of stacked Q8_0
    weights [L, d, n] dequantized to bf16."""
    if x.device.type == "cpu":
        return q8_fast_matmul_plain(x, w_q[layer], w_s[layer], group_size)
    return _launch_fast("stacked_fast", x, w_q, w_s, int(layer), group_size)


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
    xq, xs = quantize_act(x.reshape(-1, n).float(), tk)
    _check(xq, None, w_q, w_s, group_size, stacked=layer is not None,
           x_dtype=torch.int8)
    if xs.device != xq.device or not xs.is_contiguous():
        raise ValueError("activation scales must be contiguous on x's device")
    lib = load_library()
    d = w_q.shape[-2]
    b = xq.shape[0]
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if layer is None:
        err = lib.q8i8_matmul(xq.data_ptr(), xs.data_ptr(), w_q.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(), b, n, d,
                              group_size, tk, stream)
    else:
        if not 0 <= layer < w_q.shape[0]:
            raise IndexError(f"layer {layer} outside [0, {w_q.shape[0]})")
        err = lib.q8i8_matmul_stacked(xq.data_ptr(), xs.data_ptr(),
                                      w_q.data_ptr(), w_s.data_ptr(), layer,
                                      out.data_ptr(), b, n, d, group_size, tk,
                                      stream)
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.q8_fused_matmul(xf.data_ptr(), *args, w_q.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(), b, n, d,
                              group_size, groups_per_tile(n, group_size),
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


def _untiled_launch(kind, fn, x, b, n, d, group_size, block_k, args):
    """Launch an untiled kernel: the k-tiles split across blocks (with the
    ordered sum after) when the row and column blocks alone would leave
    SMs idle."""
    gpt = pick_tile(n, 8 * group_size, block_k) // group_size
    nt = n // group_size // gpt
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    blocks = -(-d // 64) * -(-b // (8 if b <= 8 else 64))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    part = None
    if nt > 1 and blocks < 2 * sms:
        part = torch.empty(nt, b, d, dtype=torch.float32, device=x.device)
    err = fn(*args, out.data_ptr(), None if part is None else part.data_ptr(),
             b, n, d, group_size, gpt)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    LAUNCHES[kind] += 1
    return out


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
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _check_untiled(x_q, x_s, w_q, w_s, group_size, torch.int8)
    *lead, n = x_q.shape
    d = w_q.shape[1]
    b = x_q.numel() // n
    lib = load_library()
    stream = torch.cuda.current_stream(x_q.device).cuda_stream

    def launch(*a):
        return lib.q8q8_untiled(*a, stream)

    out = _untiled_launch("q8q8_pallas", launch, x_q, b, n, d, group_size,
                          block_k, (x_q.data_ptr(), x_s.data_ptr(),
                                    w_q.data_ptr(), w_s.data_ptr()))
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
    from qwen3_tpu_torch.ops.cuda.build import load_library

    if x.dtype not in COMPUTE_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    xf = x.float().contiguous()
    _check_untiled(xf, None, w_q, w_s, group_size, torch.float32)
    *lead, n = x.shape
    d = w_q.shape[1]
    b = xf.numel() // n
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(*a):
        return lib.q8_untiled(*a, int(compute_dtype == torch.bfloat16),
                              int(postscale), stream)

    out = _untiled_launch("pallas", launch, xf, b, n, d, group_size, block_k,
                          (xf.data_ptr(), w_q.data_ptr(), w_s.data_ptr()))
    return out.reshape(*lead, d)
