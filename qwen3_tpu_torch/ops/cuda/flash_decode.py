"""Flash GQA attention over the KV cache: the CUDA kernels' wrappers and their
plain versions.

Replaces qwen3_tpu/ops/pallas/flash_decode.py::flash_decode_gqa (one token
per slot, the decode step at depth), ::flash_decode_gqa_two_segment (the
serving decode step over the main cache and the chunk's side buffer) and
::flash_prefill_gqa (a block of query rows, the prefill at depth). The
kernels are `csrc/flash_decode.cu`; see its header for the design and the
bound.

Layouts are the JAX functions' own:
  q        [B, H, D] (decode) or [B, T, H, D] (prefill), any float dtype
  k/v      [B, S, KV, D] float32, bfloat16 or int8
  k_s/v_s  optional float32 scales [B, S, KV] (int8 caches)
  -> float32 [B, H, D] / [B, T, H, D]
Query head h reads kv head h // (H // KV); slot b (decode) attends cache rows
0..positions[b], query row t (prefill) rows 0..q_positions[t].

Three parts of the TPU functions have no counterpart here, because they exist
for Mosaic, the TPU's kernel compiler, and not for the function:
- the [B, KV, S] transpose of the scales (`swapaxes`): Mosaic wants the tile
  axis of a block on its lanes; the kernels read [B, S, KV] in place;
- the int8 `ValueError` of `_pick_ts` (a row count with no 128-multiple tile
  does not lower there); `runtime/kvcache.py::pad_rows` keeps the engine's
  row counts at multiples of 256 anyway, so `ts` is 256 on its path;
- the BlockSpec index clamping (a past tile maps to an already-fetched block
  so that Mosaic skips its copy); the kernels simply never read past tiles.

`live` (host int, optional) is max(positions) + 1, as for the dense
functions in ops/attention.py: it bounds the tile loop of the plain versions
and the grids of the decode and prefill kernels without a read back from the
device.

The prefill kernel cuts each query tile's walk over the cache into segments
of whole 64-row chunks, so that the grid fills the card; `plan_prefill`
picks the segment length on the host and `prefill_segments` is the cut the
kernel makes.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel launches,
one per call that reaches the kernel.
"""

from __future__ import annotations

import math

import torch

from qwen3_tpu_torch.ops.q8 import const

LAUNCHES = {"flash_decode": 0, "flash_prefill": 0,
            "flash_decode_two_segment": 0}

_NEG = torch.finfo(torch.float32).min   # the JAX kernels' mask value
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 128        # the kernels hold a row's outputs in registers
MAX_SCORE_ROWS = 64       # prefill: query rows x heads of a block
PREFILL_CHUNK = 64        # prefill: cache rows a kernel step
PREFILL_SLOTS = 264       # prefill blocks resident at once: two on each of
                          # the H100's 132 SMs
PREFILL_MIN_SEG = 2       # chunks a segment at least: a block's set-up (its
                          # queries, its partial) costs about one chunk


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def pick_ts(S: int, block_s: int) -> int:
    """The S-tile: min(block_s, S), halved until it divides S
    (qwen3_tpu/ops/pallas/flash_decode.py::_pick_ts without the int8
    lowering guard). flash_prefill_gqa picks its query tile of T rows by
    the same rule from block_t."""
    ts = min(block_s, S)
    while S % ts:
        ts //= 2
    return ts


def _n_tiles(S: int, ts: int, live: int | None) -> int:
    if live is None:
        return S // ts
    return min(S // ts, -(-max(1, live) // ts))


def _accum_tile(qf, kt, vt, kst, vst, mask, active, acc, m, l, inv):
    """One online-softmax update over a cache tile, in the TPU kernel's
    arithmetic (flash_decode.py::_accum_tile). qf [B, KV, R, D] fp32 query
    rows; kt/vt [B, ts, KV, D] raw cache rows; kst/vst [B, ts, KV] or None;
    mask broadcasts to [B, KV, R, ts]; `active` to [B, KV, R, 1] (False:
    the tile lies past the rows' last position and is skipped)."""
    kf = kt.float().transpose(1, 2)                       # [B, KV, ts, D]
    vf = vt.float().transpose(1, 2)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * inv    # [B, KV, R, ts]
    if kst is not None:
        scores = scores * kst.transpose(1, 2)[:, :, None, :]
    scores = torch.where(mask, scores, _NEG)
    m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new) * mask.float()
    pv = p if vst is None else p * vst.transpose(1, 2)[:, :, None, :]
    acc_new = acc * alpha + torch.matmul(pv, vf)
    l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
    return (torch.where(active, acc_new, acc), torch.where(active, m_new, m),
            torch.where(active, l_new, l))


def _walk(qf, k_cache, v_cache, k_s, v_s, ts, n_tiles, mask_of, active_of):
    """Walk the cache tile by tile, in order; returns the online softmax's
    (acc, m, l, inv)."""
    B, KV, R, D = qf.shape
    inv = const(1.0 / math.sqrt(D), qf)
    acc = torch.zeros(B, KV, R, D, dtype=torch.float32, device=qf.device)
    m = torch.full((B, KV, R, 1), _NEG, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros(B, KV, R, 1, dtype=torch.float32, device=qf.device)
    for s in range(n_tiles):
        rows = slice(s * ts, (s + 1) * ts)
        acc, m, l = _accum_tile(
            qf, k_cache[:, rows], v_cache[:, rows],
            None if k_s is None else k_s[:, rows],
            None if v_s is None else v_s[:, rows],
            mask_of(s), active_of(s), acc, m, l, inv)
    return acc, m, l, inv


def _online_softmax(*args):
    """_walk, normalised: acc / l."""
    acc, _, l, _ = _walk(*args)
    return acc / l


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, positions: torch.Tensor,
                       k_s=None, v_s=None, block_s: int = 256, *,
                       live: int | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch, in the TPU kernel's arithmetic:
    S-tiles of `ts` rows in order, a tile past a slot's position skipped,
    per tile scores = (q . k) * (1/sqrt(D)), then times the K scale,
    masked to f32.min, the running max and rescale, p = exp(scores - m) *
    mask, acc = acc * alpha + (p * v_scale) @ v, l = l * alpha + sum(p);
    the output is acc / l."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    ts = pick_ts(S, block_s)
    qf = q.float().reshape(B, KV, H // KV, D)
    pos = positions.reshape(B)
    span = torch.arange(ts, device=q.device)

    def mask_of(s):
        return ((s * ts + span)[None, :] <= pos[:, None])[:, None, None, :]

    def active_of(s):
        return (s * ts <= pos)[:, None, None, None]

    out = _online_softmax(qf, k_cache, v_cache, k_s, v_s, ts,
                          _n_tiles(S, ts, live), mask_of, active_of)
    return out.reshape(B, H, D)


def flash_decode_two_segment_plain(q: torch.Tensor, k_main: torch.Tensor,
                                   v_main: torch.Tensor, k_side: torch.Tensor,
                                   v_side: torch.Tensor,
                                   base_pos: torch.Tensor,
                                   offsets: torch.Tensor, k_ms=None,
                                   v_ms=None, k_ss=None, v_ss=None,
                                   block_s: int = 256, *,
                                   live: int | None = None) -> torch.Tensor:
    """The two-segment kernel's function in the TPU kernel's arithmetic
    (flash_decode.py::_kernel2): the main cache's S-tiles in order, rows
    idx < base_pos[b] (a tile at or past base_pos skipped, so base_pos 0
    reads none), then the side buffer's C rows j <= offsets[b] as one more
    tile of the same online softmax; the output is acc / l. `live` (host
    int, optional) is max(base_pos), the main rows needed."""
    B, H, D = q.shape
    S, KV = k_main.shape[1], k_main.shape[2]
    C = k_side.shape[1]
    ts = pick_ts(S, block_s)
    qf = q.float().reshape(B, KV, H // KV, D)
    base = base_pos.reshape(B)
    span = torch.arange(ts, device=q.device)

    def mask_of(s):
        return ((s * ts + span)[None, :] < base[:, None])[:, None, None, :]

    def active_of(s):
        return (s * ts < base)[:, None, None, None]

    acc, m, l, inv = _walk(qf, k_main, v_main, k_ms, v_ms, ts,
                           _n_tiles(S, ts, live), mask_of, active_of)
    side_mask = (torch.arange(C, device=q.device)[None, :]
                 <= offsets.reshape(B)[:, None])[:, None, None, :]
    every = torch.ones(B, 1, 1, 1, dtype=torch.bool, device=q.device)
    acc, m, l = _accum_tile(qf, k_side, v_side, k_ss, v_ss, side_mask, every,
                            acc, m, l, inv)
    return (acc / l).reshape(B, H, D)


def flash_prefill_plain(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, q_positions: torch.Tensor,
                        k_s=None, v_s=None, block_s: int = 256,
                        block_t: int = 64, *,
                        live: int | None = None) -> torch.Tensor:
    """Block-causal prefill in the TPU kernel's arithmetic (see
    flash_decode_plain): query row t attends cache rows s <= q_positions[t];
    the queries go in tiles of tq rows, and a cache tile past the query
    tile's last position (`tile_last`) is skipped for that query tile."""
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    M = H // KV
    ts = pick_ts(S, block_s)
    tq = pick_ts(T, block_t)
    # score rows ordered (t, m) per kv head: [B, KV, T * M, D]
    qf = q.float().reshape(B, T, KV, M, D).permute(0, 2, 1, 3, 4).reshape(
        B, KV, T * M, D)
    qpos = q_positions.reshape(T)
    row_pos = qpos.repeat_interleave(M)                        # [T * M]
    tile_last = qpos.reshape(T // tq, tq)[:, -1].repeat_interleave(tq * M)
    span = torch.arange(ts, device=q.device)

    def mask_of(s):
        return ((s * ts + span)[None, :] <= row_pos[:, None])[None, None]

    def active_of(s):
        return (s * ts <= tile_last)[None, None, :, None]

    out = _online_softmax(qf, k_cache, v_cache, k_s, v_s, ts,
                          _n_tiles(S, ts, live), mask_of, active_of)
    return out.reshape(B, KV, T, M, D).permute(0, 2, 1, 3, 4).reshape(
        B, T, H, D)


def prefill_tq(T: int, M: int, block_t: int = 64) -> int:
    """The prefill kernel's query tile: flash_prefill_gqa's tile of T rows
    (pick_ts from block_t), halved until its tq * M score rows fit a block.
    A finer query tile skips more past cache rows and changes no value."""
    tq = pick_ts(T, block_t)
    while tq * M > MAX_SCORE_ROWS and tq > 1:
        tq //= 2
    return tq


def prefill_segments(chunks: int, seg: int,
                     n_seg: int) -> list[tuple[int, int]]:
    """A query tile's `chunks` 64-row chunks cut into near-equal segments of
    at most max(seg, ceil(chunks / n_seg)) chunks, in order, as [first, end)
    chunk ranges: the kernel's prefill_segment (csrc/flash_decode.cu). There
    are at most n_seg, so the grid holds every chunk whatever `live` the
    plan was made for; none is empty."""
    seg = max(seg, -(-chunks // n_seg))
    n_t = -(-chunks // seg)
    return [(j * chunks // n_t, (j + 1) * chunks // n_t) for j in range(n_t)]


def plan_prefill(T: int, tq: int, S: int, KV: int, B: int,
                 live: int | None = None) -> tuple[int, int]:
    """(seg, n_seg): the prefill kernel's segment length in chunks and its
    grid's segment axis, from shapes and `live` on the host.

    A block runs one (query tile, segment, kv head, slot). The last query
    tile sees the most chunks, those up to row live - 1 (the whole cache
    without `live`); it is cut into 2 * PREFILL_SLOTS // units segments,
    units = (T / tq) * KV * B: about two full waves, where one wave of
    ceil(PREFILL_SLOTS / units) would leave most of a second one idle
    (units rarely divides 264). A segment holds at least PREFILL_MIN_SEG
    chunks, so a tile of so few stays whole; n_seg = 1 leaves every tile
    whole and the kernel writes the output itself. `live` sizes the grid
    only (prefill_segments)."""
    last = (S if live is None else max(1, min(live, S))) - 1
    chunks = last // PREFILL_CHUNK + 1
    n = max(1, 2 * PREFILL_SLOTS // ((T // tq) * KV * B))
    seg = max(min(PREFILL_MIN_SEG, chunks), -(-chunks // n))
    return seg, -(-chunks // seg)


def _check(q, k_cache, v_cache, positions, k_s, v_s, n_pos):
    """What the kernels take: CUDA tensors on one device, contiguous,
    K/V of one dtype among float32/bfloat16/int8, scales both or neither."""
    *_, H, D = q.shape
    B, S, KV, Dk = k_cache.shape
    if Dk != D or tuple(v_cache.shape) != (B, S, KV, D) or H % KV:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if D < 16 or D > MAX_HEAD_DIM or D & (D - 1):
        raise ValueError(f"head_dim {D} not supported (a power of two from "
                         f"16 to {MAX_HEAD_DIM})")
    if k_cache.dtype not in DTYPE_CODES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"K/V must share one of {list(DTYPE_CODES)}, got "
                        f"{k_cache.dtype} and {v_cache.dtype}")
    if (k_s is None) != (v_s is None):
        raise ValueError("pass both scales or neither")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("positions", positions)]
    if k_s is not None:
        tensors += [("k_s", k_s), ("v_s", v_s)]
        for name, t in (("k_s", k_s), ("v_s", v_s)):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, S, KV):
                raise ValueError(f"{name} must be float32 {(B, S, KV)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    if positions.dtype != torch.int32 or positions.numel() != n_pos:
        raise ValueError(f"positions must be int32 with {n_pos} entries")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


_COUNTERS: dict = {}


def decode_counters(device, n: int) -> torch.Tensor:
    """The completion counters for the current stream of `device` (`cuda`
    means the current device): int32 zeros, at least n of them, one buffer
    per (device, stream), allocated on that stream at first use (and again
    only to grow). The kernels that take them (decode attention, the
    untiled matmul's split, the sampler's sums) reset each counter they use
    to 0, so every call on a stream finds them zero, and calls on two
    streams at once never share a counter."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = torch.cuda.current_stream(device)
    key = (device, stream.cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        with torch.cuda.stream(stream):
            c = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def _launch_decode(q, k_cache, v_cache, positions, k_s, v_s, block_s, live):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    M = H // KV
    q = q.float().contiguous()
    positions = positions.to(torch.int32).reshape(B).contiguous()
    _check(q, k_cache, v_cache, positions, k_s, v_s, B)
    ts = pick_ts(S, block_s)
    n_split = _n_tiles(S, ts, live)
    lib = load_library()
    part_acc = torch.empty(B, KV, n_split, M, D, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B, KV, n_split, M, 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty(B, H, D, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_s),
        _ptr(v_s), positions.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(),
        decode_counters(q.device, B * H).data_ptr(),
        DTYPE_CODES[k_cache.dtype], B, S, H, KV, D, ts, n_split,
        1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["flash_decode"] += 1
    return out


def _launch_two_segment(q, k_main, v_main, k_side, v_side, base_pos, offsets,
                        k_ms, v_ms, k_ss, v_ss, block_s, live):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    B, H, D = q.shape
    S, KV = k_main.shape[1], k_main.shape[2]
    C = k_side.shape[1]
    M = H // KV
    q = q.float().contiguous()
    base_pos = base_pos.to(torch.int32).reshape(B).contiguous()
    offsets = offsets.to(torch.int32).reshape(B).contiguous()
    _check(q, k_main, v_main, base_pos, k_ms, v_ms, B)
    _check(q, k_side, v_side, offsets, k_ss, v_ss, B)
    if (k_ms is None) != (k_ss is None):
        raise ValueError("pass the scales of both segments or neither")
    ts = pick_ts(S, block_s)
    n_main = _n_tiles(S, ts, live)
    lib = load_library()
    part_acc = torch.empty(B, KV, n_main + 1, M, D, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B, KV, n_main + 1, M, 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty(B, H, D, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_decode_two_segment(
        q.data_ptr(), k_main.data_ptr(), v_main.data_ptr(), _ptr(k_ms),
        _ptr(v_ms), k_side.data_ptr(), v_side.data_ptr(), _ptr(k_ss),
        _ptr(v_ss), base_pos.data_ptr(), offsets.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        decode_counters(q.device, B * H).data_ptr(),
        DTYPE_CODES[k_main.dtype], B, S, C, H, KV, D, ts, n_main,
        1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_two_segment kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["flash_decode_two_segment"] += 1
    return out


def _launch_prefill(q, k_cache, v_cache, q_positions, k_s, v_s, block_t,
                    live):
    from qwen3_tpu_torch.ops.cuda.build import load_library

    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    M = H // KV
    if M > MAX_SCORE_ROWS:
        raise ValueError(f"{M} query heads per kv head; at most "
                         f"{MAX_SCORE_ROWS}")
    q = q.float().contiguous()
    q_positions = q_positions.to(torch.int32).reshape(T).contiguous()
    _check(q, k_cache, v_cache, q_positions, k_s, v_s, T)
    tq = prefill_tq(T, M, block_t)
    seg, n_seg = plan_prefill(T, tq, S, KV, B, live)
    lib = load_library()
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=q.device)
    part_acc = part_ml = None
    if n_seg > 1:
        shape = (B, KV, T // tq, n_seg, MAX_SCORE_ROWS)
        part_acc = torch.empty(*shape, D, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(*shape, 2, dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_s),
        _ptr(v_s), q_positions.data_ptr(), out.data_ptr(), _ptr(part_acc),
        _ptr(part_ml), DTYPE_CODES[k_cache.dtype], B, T, S, H, KV, D, tq,
        seg, n_seg, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["flash_prefill"] += 1
    return out


def flash_decode_gqa(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     k_s=None, v_s=None, block_s: int = 256, *,
                     live: int | None = None) -> torch.Tensor:
    """Single-token GQA attention per slot: q [B, H, D], k/v_cache
    [B, S, KV, D], positions [B]; returns [B, H, D] fp32."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, positions, k_s, v_s,
                                  block_s, live=live)
    return _launch_decode(q, k_cache, v_cache, positions, k_s, v_s, block_s,
                          live)


def flash_decode_gqa_two_segment(q: torch.Tensor, k_main: torch.Tensor,
                                 v_main: torch.Tensor, k_side: torch.Tensor,
                                 v_side: torch.Tensor, base_pos: torch.Tensor,
                                 offsets: torch.Tensor, k_ms=None, v_ms=None,
                                 k_ss=None, v_ss=None, block_s: int = 256, *,
                                 live: int | None = None) -> torch.Tensor:
    """Flash decode over the serving side-buffer layout: slot b attends main
    rows idx < base_pos[b] of k/v_main [B, S, KV, D] plus side rows
    j <= offsets[b] of k/v_side [B, C, KV, D], under one online softmax.
    Scales optional ([B, S, KV] main, [B, C, KV] side: all four or none).
    `live` (host int, optional) is max(base_pos). Returns [B, H, D] fp32."""
    if q.device.type == "cpu":
        return flash_decode_two_segment_plain(
            q, k_main, v_main, k_side, v_side, base_pos, offsets, k_ms, v_ms,
            k_ss, v_ss, block_s, live=live)
    return _launch_two_segment(q, k_main, v_main, k_side, v_side, base_pos,
                               offsets, k_ms, v_ms, k_ss, v_ss, block_s, live)


def flash_prefill_gqa(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, q_positions: torch.Tensor,
                      k_s=None, v_s=None, block_s: int = 256,
                      block_t: int = 64, *,
                      live: int | None = None) -> torch.Tensor:
    """Block-causal GQA prefill attention: q [B, T, H, D], q_positions [T]
    (absolute, increasing); returns [B, T, H, D] fp32. The kernel reads each
    query tile's last position itself; `live` (max(q_positions) + 1, or
    None for the whole cache) sizes its grid (plan_prefill) and never its
    result."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_cache, v_cache, q_positions, k_s,
                                   v_s, block_s, block_t, live=live)
    return _launch_prefill(q, k_cache, v_cache, q_positions, k_s, v_s,
                           block_t, live)
