"""The sampler's reductions on the card: the fixed-order kernels' wrappers
and their ordered plain twins.

The port's own kernels (`csrc/sampler.cu`): the JAX package leaves the
sampler's softmax denominator and its prefix sum to XLA
(qwen3_tpu/runtime/sampler.py), with no Pallas kernel. runtime/sampler.py
takes them for a CUDA tensor, and torch.sum and torch.cumsum for a CPU one
(the order the JAX package's CPU streams are held to).

  softmax_sum(e)  e [B, n] float32, contiguous  ->  [B] float32 row sums
  prefix_sum(x)   x [B, n] float32, contiguous  ->  [B, n] inclusive sums

A row's order is a function of n alone (softmax_sum_ordered and
cumsum_ordered spell it in plain ops), so a row's bits do not depend on the
rows beside it; and a prefix sum's first k entries do not depend on n, so
the sampler's top-k candidates' sums are the full scan's first k. On the
card the plain versions equal the kernels bit for bit.

On the card each is one launch a call that spreads a row over the SMs in
that order: softmax_sum's 32 warps are one-warp blocks, the row's last one
to finish adding their sums (a completion counter a row,
flash_decode.decode_counters); prefix_sum's blocks take their tiles from
their row's ticket and read the earlier tiles' totals as those publish
them, so the row is read once (its tickets, counters and tile words in the
same buffers). Both leave their counters zero for the next call.

The wrappers take CUDA tensors only and launch the kernel or raise.
`LAUNCHES` counts calls that launched, one kernel a call.
"""

from __future__ import annotations

import torch

LAUNCHES = {"softmax_sum": 0, "prefix_sum": 0}
SUM_THREADS = 1024      # softmax_sum: threads a row, 4-value chunks each
SUM_BLOCKS = SUM_THREADS // 32   # softmax_sum: its one-warp blocks a row
SCAN_THREADS = 256      # prefix_sum: threads a tile
SCAN_PER = 8            # consecutive values a thread
SCAN_TILE = SCAN_THREADS * SCAN_PER
_LANES = 32


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check(x: torch.Tensor) -> None:
    """What the kernels take: a non-empty 2-D contiguous float32 tensor."""
    if x.dtype != torch.float32:
        raise TypeError(f"the sampler's sums take float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"the sampler's sums take a non-empty [B, n] "
                         f"tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the sampler's sums take contiguous rows")


def _xor_tree(acc: torch.Tensor) -> torch.Tensor:
    """A warp's __shfl_xor tree over the last axis (32 lanes): offsets 16
    .. 1, lane l adding lane l ^ off to its own; every lane ends with the
    sum."""
    lane = torch.arange(_LANES, device=acc.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc


def softmax_sum_ordered(e: torch.Tensor) -> torch.Tensor:
    """Each row's sum in the kernel's order (csrc/sampler.cu), in plain ops:
    4-value chunk c to thread c % SUM_THREADS, each thread's values in index
    order as one chain, a __shfl_xor tree over a warp's lanes, then the same
    tree over the 32 warps' sums. [B, n] -> [B]."""
    b, n = e.shape
    chunks = -(-n // 4)
    per = -(-chunks // SUM_THREADS)             # chunks a thread
    x = torch.nn.functional.pad(e.float(), (0, 4 * per * SUM_THREADS - n))
    x = x.reshape(b, per, SUM_THREADS, 4)
    acc = torch.zeros(b, SUM_THREADS, dtype=torch.float32, device=e.device)
    for j in range(per):
        for i in range(4):
            acc = acc + x[:, j, :, i]
    warps = _xor_tree(acc.reshape(b, SUM_THREADS // _LANES, _LANES))[..., 0]
    return _xor_tree(warps)[:, 0]


def _shift_lanes(s: torch.Tensor, off: int) -> torch.Tensor:
    """__shfl_up by `off` over the last axis, zeros below lane off."""
    return torch.nn.functional.pad(s[..., :-off], (off, 0))


def cumsum_ordered(x: torch.Tensor) -> torch.Tensor:
    """Each row's inclusive prefix sums in the kernel's order
    (csrc/sampler.cu), in plain ops: tiles of SCAN_TILE values, SCAN_PER
    consecutive values a thread summed in order, a Kogge-Stone scan of the
    threads' totals over a warp read one lane down, the warps' totals in
    order, the earlier tiles' totals in order; out = ((carry + warp offset)
    + lane offset) + the thread's own sum. Entry i reads entries 0..i only,
    in an order set by i: the first k sums do not depend on n. [B, n] ->
    [B, n]."""
    b, n = x.shape
    warps = SCAN_THREADS // _LANES
    nt = -(-n // SCAN_TILE)
    v = torch.nn.functional.pad(x.float(), (0, nt * SCAN_TILE - n))
    v = v.reshape(b, nt, warps, _LANES, SCAN_PER)
    sums = [v[..., 0]]
    for i in range(1, SCAN_PER):
        sums.append(sums[-1] + v[..., i])
    p = torch.stack(sums, dim=-1)                # a thread's inclusive sums
    s = p[..., -1]                               # [b, nt, warps, lanes]
    lane = torch.arange(_LANES, device=x.device)
    off = 1
    while off < _LANES:
        s = torch.where(lane >= off, s + _shift_lanes(s, off), s)
        off *= 2
    lex = _shift_lanes(s, 1)
    wt = s[..., -1]                              # [b, nt, warps]
    wex = [torch.zeros_like(wt[..., 0])]
    for w in range(warps):
        wex.append(wex[-1] + wt[..., w])
    total = wex.pop()                            # [b, nt]
    wex = torch.stack(wex, dim=-1)
    carry = [torch.zeros_like(total[:, 0])]
    for j in range(nt - 1):
        carry.append(carry[-1] + total[:, j])
    carry = torch.stack(carry, dim=-1)           # [b, nt]
    out = ((carry[..., None, None] + wex[..., None]) + lex)[..., None] + p
    return out.reshape(b, nt * SCAN_TILE)[:, :n]


def _launch(kind: str, x: torch.Tensor) -> torch.Tensor:
    from qwen3_tpu_torch.ops.cuda.build import load_library
    from qwen3_tpu_torch.ops.cuda.flash_decode import decode_counters

    if x.device.type != "cuda":
        raise ValueError(f"the {kind} kernel takes CUDA tensors, got "
                         f"{x.device}")
    check(x)
    b, n = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = load_library()
    if kind == "softmax_sum":
        out = torch.empty(b, dtype=torch.float32, device=x.device)
        partial = torch.empty(b, SUM_BLOCKS, dtype=torch.float32,
                              device=x.device)
        vec = n % 4 == 0 and x.data_ptr() % 16 == 0
        err = lib.softmax_sum(x.data_ptr(), partial.data_ptr(),
                              decode_counters(x.device, b).data_ptr(),
                              out.data_ptr(), b, n, int(vec), stream)
    else:
        out = torch.empty_like(x)
        # 2 + tiles 64-bit words a row, as int32 pairs
        state = decode_counters(x.device, 2 * b * (2 + -(-n // SCAN_TILE)))
        vec = (n % 4 == 0 and x.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
        err = lib.prefix_sum(x.data_ptr(), state.data_ptr(), out.data_ptr(),
                             b, n, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    LAUNCHES[kind] += 1
    return out


def softmax_sum(e: torch.Tensor) -> torch.Tensor:
    """Each row's sum on the card in the fixed order: one launch. [B, n]
    -> [B]."""
    return _launch("softmax_sum", e)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Each row's inclusive prefix sums on the card in the fixed order.
    [B, n] -> [B, n]."""
    return _launch("prefix_sum", x)
