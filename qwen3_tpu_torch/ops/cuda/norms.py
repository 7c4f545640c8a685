"""RMSNorm on the card: the fixed-order kernel's wrapper and its ordered
plain twin.

The port's own kernel (`csrc/rmsnorm.cu`): the JAX package computes its
norms in XLA (qwen3_tpu/ops/norms.py), with no Pallas kernel. ops/norms.py's
rmsnorm and rms_inv take it for a CUDA tensor and their plain versions
(ops/norms.py's rmsnorm_plain and rms_inv_plain, the torch.mean chain) for
a CPU one.

  x    [..., n] float32 or bfloat16; its leading dimensions must collapse
       into at most two strided levels and its last must be contiguous
       (a contiguous tensor, or the q and k heads sliced from a qkv output)
  w    [n] float32 (rmsnorm)
  ->   rmsnorm: x's shape and dtype, contiguous; rms_inv: f32 [..., 1]

A row's reduction order depends on n alone (rms_inv_ordered spells it), so
a row's bits do not depend on how many rows share its call; torch.mean on
the card picks its order by the row count. rms_inv_ordered sums in the
kernel's order and is bit-equal to the kernel on the card; it holds
NORM_RTOL of the torch.mean chain (see there).

The wrappers take CUDA tensors only and launch the kernel or raise.
`LAUNCHES` counts kernel launches, one per call.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import RMS_EPS

LAUNCHES = {"rmsnorm": 0, "rms_inv": 0}
DTYPES = (torch.float32, torch.bfloat16)
NARROW_ROW = 1024   # rows up to this wide take one warp, wider ones 128 threads
# rms_inv_ordered against the torch.mean chain, relative: two orders of a sum
# of n >= 0 terms, each within (n / threads + log2(threads) + 2) roundings of
# the exact sum (a 32-long chain at most, at n = 4096, then the tree), under
# a tenth of that bound for random rows; rsqrt halves it
NORM_RTOL = 2e-6


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def row_threads(n: int) -> int:
    """Threads that share a row of n values (the kernel's TR)."""
    return 32 if n <= NARROW_ROW else 128


def rows_layout(x: torch.Tensor) -> tuple[int, int, int, int]:
    """x's rows as the kernel walks them: (R0, s0, R1, s1), row r at element
    (r // R1) * s0 + (r % R1) * s1 from x's first. Raises ValueError when the
    last dimension is not contiguous or the leading ones do not collapse
    into two strided levels."""
    n = x.shape[-1]
    if n > 1 and x.stride(-1) != 1:
        raise ValueError(f"the norm takes rows whose last dimension is "
                         f"contiguous, got strides {x.stride()}")
    levels: list[list[int]] = []
    for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
        if size == 1:
            continue
        if levels and levels[-1][1] == size * stride:
            levels[-1] = [levels[-1][0] * size, stride]
        else:
            levels.append([size, stride])
    if len(levels) > 2:
        raise ValueError(f"the norm takes rows in at most two strided "
                         f"levels, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    while len(levels) < 2:
        levels.insert(0, [1, 0])
    (r0, s0), (r1, s1) = levels
    return r0, s0, r1, s1


def check(x: torch.Tensor,
          w: torch.Tensor | None) -> tuple[int, int, int, int]:
    """What the kernel takes: x f32 or bf16 with a non-empty last
    dimension, w f32 [n] on x's device, x's rows as rows_layout reads them;
    returns that layout."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"x must have a non-empty last dimension, got "
                         f"{tuple(x.shape)}")
    if w is not None:
        if w.dtype != torch.float32:
            raise TypeError(f"w must be float32, got {w.dtype}")
        if tuple(w.shape) != (x.shape[-1],):
            raise ValueError(f"w {tuple(w.shape)} does not match x "
                             f"{tuple(x.shape)}")
        if w.device != x.device:
            raise ValueError(f"w must be on {x.device}, got {w.device}")
    return rows_layout(x)


def rms_inv_ordered(x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """rms_inv summed in the kernel's order (csrc/rmsnorm.cu), in plain ops:
    TR = row_threads(n) threads a row, 4-value chunk c to thread c % TR,
    each thread's squares in index order as one chain, then a shfl_xor tree
    over a warp's lanes, then (s0 + s2) + (s1 + s3) over four warps; the sum
    times the rounded 1 / n, + eps, rsqrt. On the card it is the kernel's
    bits (torch.rsqrt runs the kernel's rsqrtf)."""
    *lead, n = x.shape
    tr = row_threads(n)
    sq = x.float().reshape(-1, n)
    sq = sq * sq
    chunks = -(-n // 4)
    per = -(-chunks // tr)                       # chunks a thread
    sq = torch.nn.functional.pad(sq, (0, 4 * per * tr - n))
    sq = sq.reshape(-1, per, tr, 4)
    acc = torch.zeros(sq.shape[0], tr, dtype=torch.float32, device=x.device)
    for j in range(per):
        for e in range(4):
            acc = acc + sq[:, j, :, e]
    acc = acc.reshape(-1, tr // 32, 32)
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    s = acc[..., 0]                              # [rows, warps]
    if tr // 32 > 1:
        s = (s[:, 0] + s[:, 2]) + (s[:, 1] + s[:, 3])
    else:
        s = s[:, 0]
    inv_n = torch.ones((), dtype=torch.float32) / n
    ms = s * inv_n.item()
    return torch.rsqrt(ms + eps).reshape(*lead, 1)


def _launch(x: torch.Tensor, w: torch.Tensor | None, eps: float):
    """One kernel launch on CUDA tensors: (out or None, inv or None)."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    if x.device.type != "cuda":
        raise ValueError(f"the norm kernel takes CUDA tensors, got "
                         f"{x.device}")
    r0, s0, r1, s1 = check(x, w)
    *lead, n = x.shape
    rows = r0 * r1
    bf16 = x.dtype == torch.bfloat16
    out = None if w is None else torch.empty(x.shape, dtype=x.dtype,
                                             device=x.device)
    inv = None if w is not None else torch.empty(
        *lead, 1, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out, inv
    align = 8 if bf16 else 16
    vec = (n % 4 == 0 and s0 % 4 == 0 and s1 % 4 == 0
           and x.data_ptr() % align == 0
           and (w is None or w.data_ptr() % 16 == 0))
    key = "rms_inv" if w is None else "rmsnorm"
    err = load_library().rmsnorm(
        x.data_ptr(), None if w is None else w.data_ptr(),
        None if out is None else out.data_ptr(),
        None if inv is None else inv.data_ptr(), rows, n, r1, s0, s1,
        int(bf16), int(vec), eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    return out, inv


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = RMS_EPS) -> torch.Tensor:
    """rmsnorm(x, w) on the card: one launch."""
    return _launch(x, w, eps)[0]


def rms_inv_cuda(x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """rms_inv(x) on the card: one launch."""
    return _launch(x, None, eps)[1]
