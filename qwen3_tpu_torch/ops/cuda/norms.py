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

And the folds, the same row walk with the work around a norm in its
launch (ops/norms.py states them and their chains):
  add_rmsnorm(x, y, w) -> (x + y, rmsnorm(x + y, w)), add_rms_inv(x, y) ->
  (x + y, rms_inv(x + y)): x and y contiguous, one dtype, one shape;
  qk_norm_rope(q, k, wq, wk, cos, sin) -> the rope of rmsnorm(q, wq) and of
  rmsnorm(k, wk), f32: q [B, T, H, D] and k [B, T, KV, D] as rows_layout
  reads them (views of a qkv output, or contiguous), one dtype, D even and
  at most QK_MAX_HEAD; cos and sin f32, broadcasting against [B, T, 1,
  D / 2] with their last dimension contiguous.

A row's reduction order depends on n alone (rms_inv_ordered spells it), so
a row's bits do not depend on how many rows share its call; torch.mean on
the card picks its order by the row count. rms_inv_ordered sums in the
kernel's order and is bit-equal to the kernel on the card; it holds
NORM_RTOL of the torch.mean chain (see there).

The wrappers take CUDA tensors only and launch the kernel or raise.
`LAUNCHES` counts kernel launches, one per call, by entry.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.config import RMS_EPS

LAUNCHES = {"rmsnorm": 0, "rms_inv": 0, "add_rmsnorm": 0, "add_rms_inv": 0,
            "qk_norm_rope": 0}
DTYPES = (torch.float32, torch.bfloat16)
NARROW_ROW = 1024   # rows up to this wide take one warp, wider ones 128 threads
QK_MAX_HEAD = 4096  # qk_norm_rope's widest head (8 chunks a thread of 128)
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


def rmsnorm_ordered(x: torch.Tensor, w: torch.Tensor,
                    eps: float = RMS_EPS) -> torch.Tensor:
    """rmsnorm in the kernel's order, in plain ops: (w * (x *
    rms_inv_ordered(x))).to(x.dtype), each product rounded in f32 as the
    kernel rounds it."""
    return (w.float() * (x.float() * rms_inv_ordered(x, eps))).to(x.dtype)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_card(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"the norm kernel takes CUDA tensors, got "
                             f"{t.device}")


def _launch(x: torch.Tensor, w: torch.Tensor | None, eps: float):
    """One kernel launch on CUDA tensors: (out or None, inv or None)."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _on_card(x)
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
        int(bf16), int(vec), eps, _stream(x))
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    return out, inv


def check_add(x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor | None) -> None:
    """What the add folds take: x as check() takes it, contiguous, and y
    of x's shape, dtype and device, contiguous."""
    check(x, w)
    if y.dtype != x.dtype or y.shape != x.shape or y.device != x.device:
        raise ValueError(f"y ({y.dtype}, {tuple(y.shape)}, {y.device}) must "
                         f"match x ({x.dtype}, {tuple(x.shape)}, {x.device})")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the add folds take contiguous x and y")


def _launch_add(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor | None,
                eps: float):
    """One add-fold launch on CUDA tensors: (s, out or None, inv or
    None)."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _on_card(x)
    check_add(x, y, w)
    *lead, n = x.shape
    rows = x.numel() // n
    bf16 = x.dtype == torch.bfloat16
    s = torch.empty_like(x)
    out = None if w is None else torch.empty_like(x)
    inv = None if w is not None else torch.empty(
        *lead, 1, dtype=torch.float32, device=x.device)
    if rows == 0:
        return s, out, inv
    align = 8 if bf16 else 16
    vec = (n % 4 == 0 and x.data_ptr() % align == 0
           and y.data_ptr() % align == 0
           and (w is None or w.data_ptr() % 16 == 0))
    key = "add_rms_inv" if w is None else "add_rmsnorm"
    err = load_library().add_rmsnorm(
        x.data_ptr(), y.data_ptr(), None if w is None else w.data_ptr(),
        s.data_ptr(), None if out is None else out.data_ptr(),
        None if inv is None else inv.data_ptr(), rows, n, int(bf16),
        int(vec), eps, _stream(x))
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    return s, out, inv


def check_qk(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
             wk: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> tuple[tuple, tuple, int, int]:
    """What qk_norm_rope takes (see the module docstring); returns q's
    and k's rows_layout and the tables' strides over (b, t)."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q and k must be [B, T, heads, D] of one B, T and "
                         f"D, got {tuple(q.shape)} and {tuple(k.shape)}")
    if k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"k ({k.dtype}, {k.device}) must match q "
                         f"({q.dtype}, {q.device})")
    B, T, _, D = q.shape
    if D % 2 or D > QK_MAX_HEAD:
        raise ValueError(f"qk_norm_rope takes an even head_dim of at most "
                         f"{QK_MAX_HEAD}, got {D}")
    rq, rk = check(q, wq), check(k, wk)
    for t in (cos, sin):
        if t.dtype != torch.float32:
            raise TypeError(f"cos and sin must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"cos and sin must be on {q.device}, got "
                             f"{t.device}")
    if cos.shape != sin.shape or cos.stride() != sin.stride():
        raise ValueError("cos and sin must share their shape and strides")
    try:
        ce = cos.expand(B, T, 1, D // 2)
    except RuntimeError as e:
        raise ValueError(f"cos {tuple(cos.shape)} does not broadcast "
                         f"against [B, T, 1, D / 2] = {(B, T, 1, D // 2)}"
                         ) from e
    if D > 2 and ce.stride(-1) != 1:
        raise ValueError("cos and sin take a contiguous last dimension")
    return rq, rk, ce.stride(0), ce.stride(1)


def qk_norm_rope_cuda(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
                      wk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      eps: float = RMS_EPS):
    """(rope(rmsnorm(q, wq)), rope(rmsnorm(k, wk))) on the card: one
    launch for both, f32 and contiguous."""
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _on_card(q, k)
    (q0, qs0, q1, qs1), (k0, ks0, k1, ks1), c_sb, c_st = check_qk(
        q, k, wq, wk, cos, sin)
    B, T, H, D = q.shape
    KV = k.shape[2]
    qo = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    ko = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    nq, nk = q0 * q1, k0 * k1
    if nq + nk == 0:
        return qo, ko
    bf16 = q.dtype == torch.bfloat16
    align = 8 if bf16 else 16
    vec = (D % 4 == 0 and all(s % 4 == 0 for s in (qs0, qs1, ks0, ks1))
           and q.data_ptr() % align == 0 and k.data_ptr() % align == 0
           and wq.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0)
    err = load_library().qk_norm_rope(
        q.data_ptr(), k.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        nq, q1, qs0, qs1, H, nk, k1, ks0, ks1, KV, T, c_sb, c_st, D,
        int(bf16), int(vec), eps, _stream(q))
    if err != 0:
        raise RuntimeError(f"qk_norm_rope kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["qk_norm_rope"] += 1
    return qo, ko


def add_rmsnorm_cuda(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     eps: float = RMS_EPS):
    """(x + y, rmsnorm(x + y, w)) on the card: one launch."""
    s, out, _ = _launch_add(x, y, w, eps)
    return s, out


def add_rms_inv_cuda(x: torch.Tensor, y: torch.Tensor,
                     eps: float = RMS_EPS):
    """(x + y, rms_inv(x + y)) on the card: one launch."""
    s, _, inv = _launch_add(x, y, None, eps)
    return s, inv


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = RMS_EPS) -> torch.Tensor:
    """rmsnorm(x, w) on the card: one launch."""
    return _launch(x, w, eps)[0]


def rms_inv_cuda(x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """rms_inv(x) on the card: one launch."""
    return _launch(x, None, eps)[1]
