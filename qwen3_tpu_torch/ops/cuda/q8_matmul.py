"""Q8_0 x Q8_0 matmul: the CUDA kernel's wrappers and its plain version.

Replaces qwen3_tpu/ops/pallas/q8_matmul.py::q8_q8_matmul_stacked (every layer
matmul) and ::q8_q8_matmul_tiled (the classifier). The kernel is
`csrc/q8_matmul.cu`; see its header for the design and the bound.

Layout: the checkpoint's row-major weights, one output column per row,
  x_q int8 [..., n], x_s f32 [..., n/G]
  w_q int8 [d, n],   w_s f32 [d, n/G]    (stacked: [L, d, n], [L, d, n/G])
  -> out f32 [..., d]
The TPU package's [J, n, td] tile repack (and the classifier's zero padding)
exists for the TPU's DMA blocks and has no counterpart here.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel launches,
one per call that reaches the kernel.
"""

from __future__ import annotations

import torch

LAUNCHES = {"stacked": 0, "tiled": 0}


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
                      group_size: int) -> torch.Tensor:
    """The kernel's function in PyTorch, same arithmetic in the same order.

    Each group dot is computed as a float32 product of int8 values cast to
    float32, which is exact (every partial sum is an integer below 2^24).
    Never use torch.matmul on int8 tensors: it returns int8 and wraps."""
    *lead, n = x_q.shape
    d = w_q.shape[0]
    g = group_size
    ng = n // g
    gpt = groups_per_tile(n, g)
    xg = x_q.reshape(-1, ng, g).float()            # [b, ng, G]
    wg = w_q.reshape(d, ng, g).float()             # [d, ng, G]
    xs = x_s.reshape(-1, ng).float()
    ws = w_s.float()
    b = xg.shape[0]
    out = torch.zeros(b, d, dtype=torch.float32, device=x_q.device)
    for t0 in range(0, ng, gpt):
        dots = torch.bmm(xg[:, t0:t0 + gpt].transpose(0, 1),
                         wg[:, t0:t0 + gpt].permute(1, 2, 0))   # [gpt, b, d]
        acc = torch.zeros(b, d, dtype=torch.float32, device=x_q.device)
        for i in range(gpt):
            acc = acc + dots[i] * (xs[:, t0 + i, None] * ws[None, :, t0 + i])
        out = out + acc
    return out.reshape(*lead, d)


def _check(x_q, x_s, w_q, w_s, group_size, stacked: bool):
    g = group_size
    if g < 16 or g > 512 or g & (g - 1):
        raise ValueError(f"group_size must be a power of two in [16, 512], "
                         f"got {g}")
    n = x_q.shape[-1]
    want_w = 3 if stacked else 2
    if w_q.dim() != want_w or w_s.dim() != want_w:
        raise ValueError(f"weights must be {want_w}-d, got {tuple(w_q.shape)}")
    if w_q.shape[-1] != n or n % g:
        raise ValueError(f"contraction mismatch: x {tuple(x_q.shape)}, "
                         f"w {tuple(w_q.shape)}, G={g}")
    if tuple(w_s.shape) != tuple(w_q.shape[:-1]) + (n // g,):
        raise ValueError(f"weight scales {tuple(w_s.shape)} do not match "
                         f"{tuple(w_q.shape)} at G={g}")
    if tuple(x_s.shape) != tuple(x_q.shape[:-1]) + (n // g,):
        raise ValueError(f"activation scales {tuple(x_s.shape)} do not "
                         f"match {tuple(x_q.shape)} at G={g}")
    for name, t, dt in (("x_q", x_q, torch.int8), ("x_s", x_s, torch.float32),
                        ("w_q", w_q, torch.int8), ("w_s", w_s, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != x_q.device:
            raise ValueError(f"{name} must be on {x_q.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
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
