"""The flash prefill kernel's split of the cache walk into segments
(qwen3_tpu_torch/ops/cuda/flash_decode.py: plan_prefill, prefill_segments),
on the CPU.

The segments must cover every visible 64-row chunk of every query tile
exactly once, in order, with no empty segment and no more than the grid
holds, whatever `live` the plan was made for; the planner must fill the card
at qwen3-0.6b's prefill blocks from depth 8192. The split-and-combine,
emulated here with the plain tile arithmetic, must agree with the plain
version (flash_prefill_plain) and with the JAX package's flash_prefill_gqa
in interpret mode within 2e-5 (rtol and atol), the JAX package's own flash
tolerance: the segments' partials sum in another order than one walk over
the tiles.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.pallas import flash_decode as jfd  # noqa: E402
from qwen3_tpu_torch.ops.cuda import flash_decode as tfd  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
CHUNK = tfd.PREFILL_CHUNK
# qwen3-0.6b's attention in the CLI's default 32768-row cache
H06, KV06, D06, S06 = 16, 8, 128, 32768
SLOTS = 2 * 132              # two blocks on each of the H100's SMs


def _visible_chunks(last: int, S: int) -> int:
    return min(max(last, 0) // CHUNK + 1, -(-S // CHUNK))


def _blocks(T, tq, start, S, KV, B, seg, n_seg):
    """The grid's blocks with a segment to walk, for query rows at
    positions start .. start + T - 1."""
    return KV * B * sum(
        len(tfd.prefill_segments(_visible_chunks(start + t0 + tq - 1, S),
                                 seg, n_seg))
        for t0 in range(0, T, tq))


def split_plain(q, k_cache, v_cache, q_positions, k_s, v_s, block_t, seg,
                n_seg):
    """The prefill kernel's split and combine in PyTorch: per query tile
    (prefill_tq) and segment (prefill_segments) the online softmax's
    partial (acc, m, l) over the segment's 64-row chunks in the plain tile
    arithmetic, then the tile's partials combined in segment order:
    acc = sum_j acc_j e^(m_j - m), l = sum_j l_j e^(m_j - m), m the largest
    m_j, out = acc / l."""
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    M = H // KV
    tq = tfd.prefill_tq(T, M, block_t)
    inv = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qpos = q_positions.reshape(T)
    every = torch.ones(B, 1, 1, 1, dtype=torch.bool)
    out = torch.empty(B, T, H, D, dtype=torch.float32)
    for t0 in range(0, T, tq):
        qf = q[:, t0:t0 + tq].float().reshape(B, tq, KV, M, D).permute(
            0, 2, 1, 3, 4).reshape(B, KV, tq * M, D)
        row_pos = qpos[t0:t0 + tq].repeat_interleave(M)
        chunks = _visible_chunks(int(qpos[t0 + tq - 1]), S)
        parts = []
        for first, end in tfd.prefill_segments(chunks, seg, n_seg):
            acc = torch.zeros(B, KV, tq * M, D, dtype=torch.float32)
            m = torch.full((B, KV, tq * M, 1), tfd._NEG, dtype=torch.float32)
            l = torch.zeros(B, KV, tq * M, 1, dtype=torch.float32)
            for c in range(first, end):
                rows = slice(c * CHUNK, min((c + 1) * CHUNK, S))
                span = torch.arange(rows.start, rows.stop)
                mask = (span[None, :] <= row_pos[:, None])[None, None]
                acc, m, l = tfd._accum_tile(
                    qf, k_cache[:, rows], v_cache[:, rows],
                    None if k_s is None else k_s[:, rows],
                    None if v_s is None else v_s[:, rows],
                    mask, every, acc, m, l, inv)
            parts.append((acc, m, l))
        mg = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        acc_t = torch.zeros_like(parts[0][0])
        l_t = torch.zeros_like(parts[0][2])
        for acc, m, l in parts:
            w = torch.exp(m - mg)
            acc_t = acc_t + acc * w
            l_t = l_t + l * w
        out[:, t0:t0 + tq] = (acc_t / l_t).reshape(
            B, KV, tq, M, D).permute(0, 2, 1, 3, 4).reshape(B, tq, H, D)
    return out


@pytest.mark.parametrize("n_seg", [1, 3, 4096])
@pytest.mark.parametrize("chunks", [1, 2, 3, 7, 64, 129, 136, 512])
@pytest.mark.parametrize("seg", [1, 2, 3, 4, 33, 34, 67, 512])
def test_segments_cover_each_chunk_once_in_order(chunks, seg, n_seg):
    """At most n_seg segments of at most max(seg, ceil(chunks / n_seg))
    chunks: a grid planned for fewer chunks than a tile sees still holds
    them all."""
    segs = tfd.prefill_segments(chunks, seg, n_seg)
    longest = max(seg, -(-chunks // n_seg))
    assert segs[0][0] == 0 and segs[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert all(0 < end - first <= longest for first, end in segs)
    assert len(segs) == -(-chunks // longest) <= n_seg


@pytest.mark.parametrize("T,start,S,KV,B,M", [
    (512, 8192, S06, KV06, 1, 2), (64, 8192, S06, KV06, 1, 2),
    (512, 0, S06, KV06, 1, 2), (256, 32512, S06, KV06, 1, 2),
    (32, 240, 512, 2, 2, 2), (64, 448, 512, 2, 2, 4), (48, 100, 512, 4, 3, 8),
])
@pytest.mark.parametrize("with_live", [True, False])
def test_planner_grid_covers_every_tile(T, start, S, KV, B, M, with_live):
    """Every query tile's visible chunks fall in segments the grid holds
    (n_seg of them at most), whether or not the caller passes `live`."""
    tq = tfd.prefill_tq(T, M)
    assert T % tq == 0 and tq * M <= tfd.MAX_SCORE_ROWS
    live = start + T if with_live else None
    seg, n_seg = tfd.plan_prefill(T, tq, S, KV, B, live)
    assert 1 <= seg and n_seg >= 1
    for t0 in range(0, T, tq):
        chunks = _visible_chunks(start + t0 + tq - 1, S)
        segs = tfd.prefill_segments(chunks, seg, n_seg)
        assert len(segs) <= n_seg
        covered = [c for first, end in segs for c in range(first, end)]
        assert covered == list(range(chunks))


@pytest.mark.parametrize("T,start,S,KV,B,M", [
    (512, 8192, S06, KV06, 1, 2), (64, 8192, S06, KV06, 1, 2),
    (64, 32704, S06, KV06, 1, 2), (32, 240, 512, 2, 2, 2),
])
@pytest.mark.parametrize("live", [1, 64, 4096])
def test_planner_grid_covers_every_tile_with_live_below_positions(
        T, start, S, KV, B, M, live):
    """A `live` below the positions plans a smaller grid; every visible
    chunk still falls in exactly one of its segments."""
    tq = tfd.prefill_tq(T, M)
    seg, n_seg = tfd.plan_prefill(T, tq, S, KV, B, live)
    for t0 in range(0, T, tq):
        chunks = _visible_chunks(start + t0 + tq - 1, S)
        segs = tfd.prefill_segments(chunks, seg, n_seg)
        assert 1 <= len(segs) <= n_seg
        covered = [c for first, end in segs for c in range(first, end)]
        assert covered == list(range(chunks))


@pytest.mark.parametrize("T", [512, 64])
def test_planner_fills_the_card_from_depth_8192(T):
    """At least two blocks an SM of the H100 (264) at qwen3-0.6b's prefill
    blocks of 512 and 64 rows from depth 8192, counted from the tiles'
    real positions, and no more than two waves of them."""
    tq = tfd.prefill_tq(T, H06 // KV06)
    seg, n_seg = tfd.plan_prefill(T, tq, S06, KV06, 1, 8192 + T)
    blocks = _blocks(T, tq, 8192, S06, KV06, 1, seg, n_seg)
    assert tfd.PREFILL_SLOTS == SLOTS
    assert SLOTS <= blocks <= 2 * SLOTS and n_seg > 1


def test_planner_leaves_a_short_tile_whole():
    """A block whose tiles see one chunk each, or as few as PREFILL_MIN_SEG,
    is not split, and a grid whose tiles alone fill two waves (64 slots)
    splits nothing."""
    tq = tfd.prefill_tq(64, 2)
    assert tfd.plan_prefill(64, tq, S06, KV06, 1, 64)[1] == 1
    seg, _ = tfd.plan_prefill(512, tq, S06, KV06, 1, 512)
    assert seg >= tfd.PREFILL_MIN_SEG
    assert tfd.plan_prefill(512, tq, S06, KV06, 64, 8704)[1] == 1


def _cache(rng, b, s, kv, d, dtype):
    """-> ((jax values, jax scales), (torch values, torch scales))."""
    f = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    if dtype == "int8":
        sc = (np.abs(f).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
        q = np.clip(np.round(f / sc[..., None]), -127, 127).astype(np.int8)
        return ((jnp.asarray(q), jnp.asarray(sc)),
                (torch.from_numpy(q), torch.from_numpy(sc)))
    return ((jnp.asarray(f, dtype=jnp.dtype(dtype)), None),
            (torch.from_numpy(f).to(getattr(torch, dtype)), None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("T,start,block_t", [(32, 0, 16), (32, 240, 16),
                                             (64, 448, 64)])
@pytest.mark.parametrize("n_seg", [1, 8, 264])
def test_split_plain_matches_plain_and_pallas(dtype, T, start, block_t,
                                              n_seg):
    """B 2, 4 heads over 2 kv heads of 64, a 512-row cache, segments of one
    chunk at most as many as the grid holds: one leaves every tile whole,
    8 cuts the longer tiles into up to 8, 264 gives every chunk its own."""
    B, H, KV, D, S = 2, 4, 2, 64, 512
    rng = np.random.default_rng(T + start + n_seg)
    (jk, jks), (tk, tks) = _cache(rng, B, S, KV, D, dtype)
    (jv, jvs), (tv, tvs) = _cache(rng, B, S, KV, D, dtype)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    pos = start + np.arange(T)
    got = split_plain(torch.from_numpy(q), tk, tv, torch.from_numpy(pos),
                      tks, tvs, block_t, 1, n_seg)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    want = tfd.flash_prefill_plain(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(pos), tks, tvs,
                                   block_t=block_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jax_out = jfd.flash_prefill_gqa(jnp.asarray(q), jk, jv,
                                    jnp.asarray(pos, jnp.int32), jks, jvs,
                                    block_s=256, block_t=block_t,
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)


def test_split_plain_without_live_reads_the_same():
    """Grids planned with `live`, without it (the whole cache) and with a
    `live` below the positions cut other segments and give the same
    values within the tolerance."""
    B, H, KV, D, S, T = 1, 4, 2, 64, 512, 32
    rng = np.random.default_rng(5)
    _, (tk, _) = _cache(rng, B, S, KV, D, "float32")
    _, (tv, _) = _cache(rng, B, S, KV, D, "float32")
    q = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(
        np.float32))
    pos = torch.arange(300, 300 + T)
    tq = tfd.prefill_tq(T, H // KV, 16)
    outs = [split_plain(q, tk, tv, pos, None, None, 16,
                        *tfd.plan_prefill(T, tq, S, KV, B, live))
            for live in (300 + T, None, 1)]
    for other in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), other.numpy(), **TOL)


@pytest.mark.parametrize("T,live", [(64, None), (64, 1), (512, None),
                                    (512, 4096)])
def test_split_plain_at_qwen3_06b_shape(T, live):
    """qwen3-0.6b's attention (16 heads over 8 kv heads of 128, int8 KV)
    at depth 8192, in the planner's segments for the `live` the model
    passes (None: start + T), and for a `live` below the positions; within
    2e-5 of the plain version."""
    start, S = 8192, 8192 + 512
    rng = np.random.default_rng(T)
    _, (tk, tks) = _cache(rng, 1, S, KV06, D06, "int8")
    _, (tv, tvs) = _cache(rng, 1, S, KV06, D06, "int8")
    q = torch.from_numpy(rng.standard_normal((1, T, H06, D06)).astype(
        np.float32))
    pos = torch.arange(start, start + T)
    tq = tfd.prefill_tq(T, H06 // KV06)
    seg, n_seg = tfd.plan_prefill(T, tq, S, KV06, 1,
                                  start + T if live is None else live)
    if live is None:
        assert n_seg > 1
    got = split_plain(q, tk, tv, pos, tks, tvs, 64, seg, n_seg)
    want = tfd.flash_prefill_plain(q, tk, tv, pos, tks, tvs,
                                   live=start + T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
