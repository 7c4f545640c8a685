"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The matmul kernels are bit-equal to their plain versions: the group dots are
exact integers and the fp32 scale-and-sum rounds every product and every sum
in the same order in both (see qwen3_tpu_torch/csrc/q8_matmul.cu); the
pallas-fast kernel's products of bf16 values are exact in fp32 and it sums
in the plain version's order. The attention kernels sum in another order
than theirs and are held to 2e-5 (plus, under pallas-fast, the bf16
rounding of the value dot's operands, per element, see _value_tol).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.ops import norms as tq_norms  # noqa: E402
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402
from qwen3_tpu_torch.ops.q8 import quantize_act  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, n, d, g, layers, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    wq = rng.integers(-127, 128, size=(layers, d, n)).astype(np.int8)
    ws = (0.02 / 127 * (0.5 + rng.random((layers, d, n // g)))).astype(
        np.float32)
    xq, xs = quantize_act(x.to(dev), g)
    return xq, xs, torch.from_numpy(wq).to(dev), torch.from_numpy(ws).to(dev)


@pytest.mark.parametrize("b", [1, 2, 33, 64, 130])
@pytest.mark.parametrize("n,g", [(128, 32), (1024, 64), (3072, 64),
                                 (640, 64)])
def test_kernel_matches_plain_on_card(dev, b, n, g):
    """Both kernels (b = 1 runs the GEMV, b > 1 the row-block kernel), bit
    for bit, with one launch counted per call."""
    xq, xs, wq, ws = _inputs(b + n, b, n, 200, g, 2, dev)
    tq.reset_launches()
    got = tq.q8_q8_matmul_stacked(xq, xs, wq, ws, 1, g)
    want = tq.q8q8_matmul_plain(xq, xs, wq[1], ws[1], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked"] == 1
    assert torch.equal(got, want)
    got = tq.q8_q8_matmul_tiled(xq, xs, wq[0], ws[0], g)
    want = tq.q8q8_matmul_plain(xq, xs, wq[0], ws[0], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["tiled"] == 1
    assert torch.equal(got, want)


# qwen3-4b's layer matrices (n, d): wqkv, wo, w13, w2
QWEN3_4B_MATRICES = ((2560, 6144), (4096, 2560), (2560, 19456), (9728, 2560))
FAST_CASES = ([(b, n, g, 200) for n, g in ((128, 32), (1024, 64), (3072, 64))
               for b in (1, 2, 8, 9, 64, 130)]
              + [(b, n, 64, d) for n, d in QWEN3_4B_MATRICES
                 for b in (64, 128, 384, 1024)])


def _assert_one_route(b, n, d, g, kind):
    """One launch of `kind` and one route count, the route plan_fast's."""
    route = tq.plan_fast(b, n, d, g, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert tq.LAUNCHES[kind] == 1
    assert tq.LAUNCHES["fast_split" if route == tq.FAST_SPLIT
                       else "fast_tile"] == 1
    assert sum(tq.LAUNCHES[k] for k in tq.ROUTE_KEYS) == 1
    return route


@pytest.mark.parametrize("b,n,g,d", FAST_CASES)
def test_fast_kernel_matches_plain_on_card(dev, b, n, g, d):
    """The pallas-fast kernels on plan_fast's route (the group split at 1,
    2, 4 or 8 rows a block for b <= 8, the tile kernel's shapes or the
    split above), bit for bit against the plain version and against the
    same rows of the b = 1024 call, with one launch and one route counted
    per call; qwen3-4b's layer matrices at b >= 128 take the tile."""
    rng = np.random.default_rng(b * 7 + n + d)
    x = torch.from_numpy(rng.standard_normal((1024, n)).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16)
    wq, ws = _weights(rng, 2, d, n, g, dev)
    widest = tq.q8_matmul_stacked_fast(x, wq, ws, 1, g)
    xb = x[:b].contiguous()
    tq.reset_launches()
    got = tq.q8_matmul_stacked_fast(xb, wq, ws, 1, g)
    want = tq.q8_fast_matmul_plain(xb, wq[1], ws[1], g)
    torch.cuda.synchronize()
    route = _assert_one_route(b, n, d, g, "stacked_fast")
    if (n, d) in QWEN3_4B_MATRICES and b >= 128:
        assert route != tq.FAST_SPLIT
    assert torch.equal(got, want)
    assert torch.equal(got, widest[:b])
    tq.reset_launches()
    got = tq.q8_matmul_tiled_fast(xb, wq[0], ws[0], g)
    torch.cuda.synchronize()
    _assert_one_route(b, n, d, g, "tiled_fast")
    assert torch.equal(got, tq.q8_fast_matmul_plain(xb, wq[0], ws[0], g))


def test_fast_kernel_rows_do_not_depend_on_the_batch(dev):
    """Row r of a b = 64 call (32-row blocks) equals, bit for bit, the same
    row run alone (one row a block) and within b = 8."""
    rng = np.random.default_rng(1)
    n, d, g = 1024, 4096, 64
    x = torch.from_numpy(rng.standard_normal((64, n)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(d, n)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (d, n // g)))).astype(np.float32)).to(dev)
    full = tq.q8_matmul_tiled_fast(x, wq, ws, g)
    eight = tq.q8_matmul_tiled_fast(x[8:16].contiguous(), wq, ws, g)
    assert torch.equal(full[8:16], eight)
    for r in (0, 13, 63):
        alone = tq.q8_matmul_tiled_fast(x[r:r + 1].contiguous(), wq, ws, g)
        assert torch.equal(full[r:r + 1], alone)


RAGGED_B = (1, 2, 3, 7, 8, 9, 13, 64, 65, 128)
# (n, G, d): d off the fast kernel's column tiles (4-32 columns) and the
# int8 kernel's 16; the last pass of groups ragged at n / G = 48
RAGGED_SHAPES = ((1024, 64, 200), (3072, 64, 1000), (1024, 32, 200),
                 (1536, 64, 72))


# the fast kernel's own: d off every tile's columns and off 4 (scalar
# stores), G 16 and 256, and a qwen3-4b-wide contraction at 2600 columns
FAST_RAGGED_SHAPES = ((1024, 16, 198), (2048, 256, 136), (2560, 64, 2600))


@pytest.mark.parametrize("n,g,d", RAGGED_SHAPES + FAST_RAGGED_SHAPES)
@pytest.mark.parametrize("b", RAGGED_B + (200, 511))
def test_fast_kernel_ragged_rows_on_card(dev, b, n, g, d):
    """The fast kernel at ragged b and d, on plan_fast's route and forced on
    every other (the group split, each tile shape): bit-equal to its plain
    version, each row equal to the same row of the b = 512 call, one launch
    and one route a call."""
    rng = np.random.default_rng(b + n + d + g)
    x = torch.from_numpy(rng.standard_normal((512, n)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    wq, ws = _weights(rng, 2, d, n, g, dev)
    widest = tq.q8_matmul_stacked_fast(x, wq, ws, 1, g)
    xb = x[:b].contiguous()
    tq.reset_launches()
    got = tq.q8_matmul_stacked_fast(xb, wq, ws, 1, g)
    torch.cuda.synchronize()
    _assert_one_route(b, n, d, g, "stacked_fast")
    want = tq.q8_fast_matmul_plain(xb, wq[1], ws[1], g)
    assert torch.equal(got, want)
    assert torch.equal(got, widest[:b])
    for route in (tq.FAST_SPLIT, *range(len(tq.FAST_TILE_SHAPES))):
        tq.reset_launches()
        forced = tq.q8_fast_launch(xb, wq, ws, g, route, layer=1)
        torch.cuda.synchronize()
        assert tq.LAUNCHES["stacked_fast"] == 1
        assert torch.equal(forced, want), route


@pytest.mark.parametrize("n,g,d", RAGGED_SHAPES + ((768, 64, 200),))
@pytest.mark.parametrize("b", RAGGED_B)
def test_int8_kernel_ragged_rows_on_card(dev, b, n, g, d):
    """The tensor-core int8 kernel at ragged b and d (768: the whole-axis
    k-tile): bit-equal to its plain version, each row equal to the same row
    of the b = 512 call, one launch a call."""
    rng = np.random.default_rng(b + n + d + g)
    x = torch.from_numpy(rng.standard_normal((512, n)).astype(
        np.float32)).to(dev)
    wq, ws = _weights(rng, 2, d, n, g, dev)
    widest = tq.q8i8_matmul_stacked(x, wq, ws, 1, g)
    tq.reset_launches()
    got = tq.q8i8_matmul_stacked(x[:b].contiguous(), wq, ws, 1, g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked_int8"] == 1
    assert torch.equal(got, tq.q8i8_matmul_plain(x[:b], wq[1], ws[1], g))
    assert torch.equal(got, widest[:b])


def _weights(rng, layers, d, n, g, dev):
    wq = torch.from_numpy(rng.integers(-127, 128, size=(layers, d, n)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (layers, d, n // g)))).astype(np.float32)).to(dev)
    return wq, ws


@pytest.mark.parametrize("b", [1, 8, 9, 64, 130])
@pytest.mark.parametrize("n,g", [(128, 32), (512, 64), (768, 64),
                                 (3072, 64)])
def test_int8_kernel_matches_plain_on_card(dev, b, n, g):
    """The pallas-int8 kernels (one k-tile, the whole-axis fallback at 768,
    six tiles at 3072), bit for bit, one launch counted per call; a row's
    bits are the same alone and within the call."""
    rng = np.random.default_rng(b * 5 + n)
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(
        np.float32)).to(dev)
    wq, ws = _weights(rng, 2, 200, n, g, dev)
    tq.reset_launches()
    got = tq.q8i8_matmul_stacked(x, wq, ws, 1, g)
    want = tq.q8i8_matmul_plain(x, wq[1], ws[1], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked_int8"] == 1
    assert torch.equal(got, want)
    got = tq.q8i8_matmul_tiled(x, wq[0], ws[0], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["tiled_int8"] == 1
    assert torch.equal(got, tq.q8i8_matmul_plain(x, wq[0], ws[0], g))
    alone = tq.q8i8_matmul_tiled(x[b - 1:].contiguous(), wq[0], ws[0], g)
    assert torch.equal(got[b - 1:], alone)


# the fused kernel's batches (the GEMV and the fast split kernel with the
# prologue loader at 1; past it the prologue pass, then the MMA tile's 16-,
# 32- and 64-row shapes, with and without a k-split, or the fast split and
# tile kernels) and its (n, G, d): G 16-128, d not a multiple of the GEMV's
# (8 or 16) or the tiles' (64) columns, and k-tiles of 512, 256 (n = 768,
# G = 32) and the whole axis (n = 640, G = 64)
FUSED_B = (1, 2, 7, 8, 9, 16, 17, 64, 65, 512)
FUSED_SHAPES = [(128, 32, 200), (1024, 64, 203), (640, 64, 203),
                (768, 32, 203), (512, 16, 72), (1024, 128, 203)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("prologue", ["norm", "none", "swiglu"])
@pytest.mark.parametrize("n,g,d", FUSED_SHAPES)
def test_fused_kernel_matches_plain_on_card(dev, n, g, d, prologue, exact):
    """The prologue-fused kernel at every b of FUSED_B against its plain
    version (the port's unfused chain in plain ops) and against the unfused
    kernel on the plain prologue's output, bit for bit (the swiglu
    prologue's sigmoid is torch.sigmoid's formula and expf), one launch
    counted per call; each row equal to the same row of the b = 512 call
    and to the same row run alone."""
    rng = np.random.default_rng(n * 3 + g + d + exact)
    width = 2 * n if prologue == "swiglu" else n
    x_all = torch.from_numpy(rng.standard_normal((512, width)).astype(
        np.float32)).to(dev)
    nw = torch.from_numpy((1 + 0.1 * rng.standard_normal(n)).astype(
        np.float32)).to(dev)
    wq, ws = _weights(rng, 1, d, n, g, dev)

    def row_inv(x):
        # the norm kernel's row factors: a row's do not depend on the rows
        # beside it
        return tq_norms.rms_inv(x) if prologue == "norm" else None

    def fused(rows):
        x = x_all[rows].contiguous()
        return tq.q8_matmul_fused(x, wq[0], ws[0], g, row_inv(x), nw,
                                  prologue=prologue, exact=exact)

    widest = fused(slice(0, 512))
    alone = {r: fused(slice(r, r + 1)) for r in (0, 6, 511)}
    for b in FUSED_B:
        x = x_all[:b].contiguous()
        inv = row_inv(x)
        tq.reset_launches()
        got = fused(slice(0, b))
        torch.cuda.synchronize()
        assert tq.LAUNCHES["fused"] == 1, b
        want = tq.q8_fused_matmul_plain(x, wq[0], ws[0], g, inv, nw,
                                        prologue=prologue, exact=exact)
        h = tq.fused_prologue(x, inv, nw, prologue)
        if exact:
            unfused = tq.q8_q8_matmul_tiled(*quantize_act(h, g), wq[0], ws[0],
                                            g)
        else:
            unfused = tq.q8_matmul_tiled_fast(h.to(torch.bfloat16), wq[0],
                                              ws[0], g)
        torch.cuda.synchronize()
        assert torch.equal(got, want), b
        assert torch.equal(got, unfused), b
        assert torch.equal(got, widest[:b]), b
        for r, one in alone.items():
            if r < b:
                assert torch.equal(got[r], one[0]), (b, r)


def _flash_cache(seed, b, s, kv, d, dtype, dev):
    """(k, v, k_s, v_s) on the card from numpy; int8 with per-row scales."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        f = rng.standard_normal((b, s, kv, d)).astype(np.float32)
        if dtype == "int8":
            sc = (np.abs(f).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
            q = np.clip(np.round(f / sc[..., None]), -127, 127)
            out.append((torch.from_numpy(q.astype(np.int8)).to(dev),
                        torch.from_numpy(sc).to(dev)))
        else:
            out.append((torch.from_numpy(f).to(getattr(torch, dtype)).to(dev),
                        None))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _flash_close(got, want):
    """The flash tolerance of the JAX package's own tests, 2e-5, scaled by
    max(1, max|plain|): the kernels sum in another order than the plain
    versions (split tiles, fmaf)."""
    assert torch.isfinite(got).all()
    tol = 2e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 64), (16, 8, 128), (16, 2, 128)])
def test_flash_decode_matches_plain_on_card(dev, dtype, h, kv, d):
    """Slots at the tile edges (0, ts-1, ts, S-1 and between), with and
    without `live`, one launch counted per call."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s = 3, 512
    k, v, ks, vs = _flash_cache(h + d, b, s, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    for pos_set in ([0, 255, 256], [511, 5, 300]):
        pos = torch.tensor(pos_set, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q, k, v, pos, ks, vs)
        for live in (None, max(pos_set) + 1):
            fd.reset_launches()
            got = fd.flash_decode_gqa(q, k, v, pos, ks, vs, live=live)
            torch.cuda.synchronize()
            assert fd.LAUNCHES == {"flash_decode": 1, "flash_prefill": 0,
                                   "flash_decode_two_segment": 0}
            _flash_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kv,d,t,block_t", [(4, 2, 64, 32, 16),
                                              (16, 8, 128, 64, 64),
                                              (8, 2, 128, 128, 64)])
def test_flash_prefill_matches_plain_on_card(dev, dtype, h, kv, d, t,
                                             block_t):
    """Blocks that start at 0, across a tile boundary and at the end of the
    cache; (8, 2) has 4 heads per kv head, so the kernel's query tile halves
    to 16 rows."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s = 2, 512
    k, v, ks, vs = _flash_cache(h + d + t, b, s, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (b, t, h, d)).astype(np.float32)).to(dev)
    for start in (0, 256 - t // 2, s - t):
        qpos = torch.arange(start, start + t, dtype=torch.int32, device=dev)
        want = fd.flash_prefill_plain(q, k, v, qpos, ks, vs, block_t=block_t)
        fd.reset_launches()
        got = fd.flash_prefill_gqa(q, k, v, qpos, ks, vs, block_t=block_t)
        torch.cuda.synchronize()
        assert fd.LAUNCHES == {"flash_decode": 0, "flash_prefill": 1,
                               "flash_decode_two_segment": 0}
        _flash_close(got, want)


GEMV_L = 3


@pytest.mark.parametrize("d", [1, 33, 1024, 4097, 16512])
@pytest.mark.parametrize("g", [32, 64])
@pytest.mark.parametrize("n", [768, 1024, 2560, 3072, 9728])
def test_gemv_matches_plain_on_card(dev, n, g, d):
    """The b = 1 GEMV bit for bit at qwen3-0.6b's and qwen3-4b's contraction
    lengths, ragged column counts (one block short, several warps a column
    at 1024, two columns a warp at 16512), stacked at the first and last
    layer, and as the classifier's single tensor."""
    xq, xs, wq, ws = _inputs(n + d + g, 1, n, d, g, GEMV_L, dev)
    tq.reset_launches()
    for layer in (0, GEMV_L - 1):
        got = tq.q8_q8_matmul_stacked(xq, xs, wq, ws, layer, g)
        want = tq.q8q8_matmul_plain(xq, xs, wq[layer], ws[layer], g)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    got = tq.q8_q8_matmul_tiled(xq[0], xs[0], wq[1], ws[1], g)
    want = tq.q8q8_matmul_plain(xq[0], xs[0], wq[1], ws[1], g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tq.LAUNCHES["stacked"] == 2 and tq.LAUNCHES["tiled"] == 1


PREFILL_S = 32768


@pytest.mark.parametrize("t", [64, 512])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flash_prefill_split_matches_plain_on_card(dev, dtype, m, d, t):
    """The split prefill kernel within 2e-5 in a 32768-row cache, blocks
    of t rows starting at 0, 8192 and 32256, 2 kv heads of d with m query
    heads each; each call the same bits twice, one launch counted."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    kv = 2
    k, v, ks, vs = _flash_cache(m + d + t, 1, PREFILL_S, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(t + m).standard_normal(
        (1, t, kv * m, d)).astype(np.float32)).to(dev)
    for start in (0, 8192, 32256):
        qpos = torch.arange(start, start + t, dtype=torch.int32, device=dev)
        want = fd.flash_prefill_plain(q, k, v, qpos, ks, vs, live=start + t)
        fd.reset_launches()
        got = fd.flash_prefill_gqa(q, k, v, qpos, ks, vs, live=start + t)
        again = fd.flash_prefill_gqa(q, k, v, qpos, ks, vs, live=start + t)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["flash_prefill"] == 2
        assert torch.equal(got, again)
        _flash_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flash_prefill_unsplit_and_whole_cache_grids_on_card(dev, dtype):
    """qwen3-0.6b's shape: a 64-row block at 0, which the planner leaves
    unsplit (the kernel writes the output itself), and a block at 8192
    whose grid is sized without `live` (for the whole cache)."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    h, kv, d, t = 16, 8, 128, 64
    k, v, ks, vs = _flash_cache(7, 1, PREFILL_S, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, t, h, d)).astype(np.float32)).to(dev)
    tq_ = fd.prefill_tq(t, h // kv)
    assert fd.plan_prefill(t, tq_, PREFILL_S, kv, 1, t)[1] == 1
    assert fd.plan_prefill(t, tq_, PREFILL_S, kv, 1, None)[1] > 1
    for start, live in ((0, t), (8192, None)):
        qpos = torch.arange(start, start + t, dtype=torch.int32, device=dev)
        want = fd.flash_prefill_plain(q, k, v, qpos, ks, vs)
        got = fd.flash_prefill_gqa(q, k, v, qpos, ks, vs, live=live)
        torch.cuda.synchronize()
        _flash_close(got, want)


@pytest.mark.parametrize("t", [64, 512])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flash_prefill_live_below_positions_on_card(dev, dtype, t):
    """qwen3-0.6b's shape: a `live` below the query positions plans a
    smaller grid (one segment at live 1, fewer than the tiles see at
    start // 2); `live` sizes the grid only, so the output still holds
    2e-5 of the plain version."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    h, kv, d = 16, 8, 128
    k, v, ks, vs = _flash_cache(9 + t, 1, PREFILL_S, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (1, t, h, d)).astype(np.float32)).to(dev)
    for start in (8192, 32256):
        qpos = torch.arange(start, start + t, dtype=torch.int32, device=dev)
        want = fd.flash_prefill_plain(q, k, v, qpos, ks, vs)
        for live in (1, start // 2):
            got = fd.flash_prefill_gqa(q, k, v, qpos, ks, vs, live=live)
            torch.cuda.synchronize()
            _flash_close(got, want)


def _value_tol(want, mag, fast):
    """Per element: 2e-5 * max(1, max|want|), plus under `fast` 2^-8 * mag,
    mag = sum_s p_s * |v_s * vs_s| (batched_decode_magnitude). The value
    dot's operand p * vs is rounded to bf16, by at most 2^-8 of itself; the
    kernel's p is relative to the running max of the rows its lane group
    has read so far, the plain version's to that of the Pallas kernel's
    tiles, so the two round each term independently (a gap of 2^-7 * mag would need every pair of
    roundings at opposite extremes)."""
    tol = 2e-5 * max(1.0, want.abs().max().item())
    return tol + 2.0 ** -8 * mag if fast else tol


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 128), (16, 8, 128), (16, 2, 64)])
def test_batched_decode_matches_plain_on_card(dev, dtype, fast, h, kv, d):
    """Row limits 0 (no row: acc 0, m finfo.min, l 0), 1, a tile edge and
    the whole bucket; buckets 384 (the plain version's 128-row tiles) and
    the full cache; one launch per call; a slot's bits do not depend on
    the bucket or on the other slots."""
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd

    b, s, layers = 4, 512, 2
    k, v, ks, vs = (t if t is None else t.reshape(layers, b, *t.shape[1:])
                    for t in _flash_cache(h + d, layers * b, s, kv, d,
                                          dtype, dev))
    q = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    outs = {}
    for bucket, lims in ((384, [0, 1, 256, 384]), (None, [0, 1, 256, 512])):
        lim = torch.tensor(lims, dtype=torch.int32, device=dev)
        want = bd.batched_decode_plain(q, k, v, 1, lim, ks, vs,
                                       bucket=bucket, fast=fast)
        bd.reset_launches()
        got = bd.batched_decode_partial(q, k, v, 1, lim, ks, vs,
                                        bucket=bucket, fast=fast)
        torch.cuda.synchronize()
        assert bd.LAUNCHES == {"batched_decode_partial": 1}
        assert all(torch.isfinite(t).all() for t in got)
        assert torch.equal(got[0][0], torch.zeros_like(got[0][0]))
        assert (got[1][0] == torch.finfo(torch.float32).min).all()
        assert torch.equal(got[2][0], torch.zeros_like(got[2][0]))
        assert (got[1] - want[1]).abs().max().item() <= 2e-5 * max(
            1.0, want[1][1:].abs().max().item())     # slots with rows
        assert (got[2] - want[2]).abs().max().item() <= 2e-5 * max(
            1.0, want[2].abs().max().item())
        mag = bd.batched_decode_magnitude(q, k, v, 1, lim, ks, vs,
                                          bucket=bucket)
        assert ((got[0] - want[0]).abs()
                <= _value_tol(want[0], mag, fast)).all()
        outs[bucket] = got
    # slots 1 and 2 have the same rows under both buckets
    for t384, tall in zip(outs[384], outs[None]):
        assert torch.equal(t384[1:3], tall[1:3])
    q2 = q.clone()
    q2[0] += 1.0
    lim = torch.tensor([0, 1, 256, 512], dtype=torch.int32, device=dev)
    other = bd.batched_decode_partial(q2, k, v, 1, lim, ks, vs, bucket=None,
                                      fast=fast)
    for a, c in zip(other, outs[None]):
        assert torch.equal(a[1:], c[1:])
    # q = 0: every live p is exactly 1 in any frame, so under `fast` both
    # round the same p * vs and acc agrees to the fp32 sums' order; without
    # that rounding it would not
    zero = torch.zeros_like(q)
    want0 = bd.batched_decode_plain(zero, k, v, 1, lim, ks, vs, bucket=None,
                                    fast=fast)
    got0 = bd.batched_decode_partial(zero, k, v, 1, lim, ks, vs,
                                     bucket=None, fast=fast)
    tol0 = _value_tol(want0[0], None, False)
    assert (got0[0] - want0[0]).abs().max().item() <= tol0
    if fast and vs is not None:
        raw = bd.batched_decode_plain(zero, k, v, 1, lim, ks, vs,
                                      bucket=None, fast=False)
        assert (raw[0] - want0[0]).abs().max().item() > tol0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flash_two_segment_matches_plain_on_card(dev, dtype):
    """Base positions 0 (no main tile), 1, 255, 256 and S-1, side offsets
    across the 32-row chunk, with and without `live`."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s, c, h, kv, d = 5, 512, 32, 16, 8, 128
    k, v, ks, vs = _flash_cache(3, b, s, kv, d, dtype, dev)
    sk, sv, sks, svs = _flash_cache(4, b, c, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    base = torch.tensor([0, 1, 255, 256, 511], dtype=torch.int32,
                        device=dev)
    off = torch.tensor([0, 31, 7, 16, 3], dtype=torch.int32, device=dev)
    want = fd.flash_decode_two_segment_plain(q, k, v, sk, sv, base, off, ks,
                                             vs, sks, svs)
    for live in (None, 511):
        fd.reset_launches()
        got = fd.flash_decode_gqa_two_segment(q, k, v, sk, sv, base, off, ks,
                                              vs, sks, svs, live=live)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["flash_decode_two_segment"] == 1
        _flash_close(got, want)


def test_flash_refuses_what_the_kernel_does_not_take(dev):
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    k, v, ks, vs = _flash_cache(0, 1, 256, 2, 64, "int8", dev)
    q = torch.zeros(1, 4, 64, device=dev)
    pos = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="both scales"):
        fd.flash_decode_gqa(q, k, v, pos, ks, None)
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode_gqa(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v, pos, ks, vs)
    with pytest.raises(ValueError, match="on "):
        fd.flash_decode_gqa(q, k.cpu(), v, pos, ks, vs)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_forward_on_card_matches_cpu(dev, tmp_path, attn):
    """A `tiny` model's prefill and decode logits on the card against the
    same model on the CPU (plain versions): the matmul kernels are
    bit-equal to their plain versions; the other ops (rsqrt, exp, the
    attention) may differ by ulps between the devices, hence 1e-4."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.synthetic import synthetic_weights
    from qwen3_tpu_torch.models import qwen3 as model

    cfg = PRESETS["tiny"]
    w = synthetic_weights(cfg, seed=3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    outs = []
    for device in (dev, torch.device("cpu")):
        p = model.init_params(w, max_seq_len=64, device=device)
        k, v = model.init_kv_cache(cfg, 1, 64, "int8", device)
        pre, k, v = model.forward(p, cfg, torch.from_numpy(toks).to(device),
                                  k, v, 0, all_logits=True, attn=attn)
        dec, k, v = model.decode_forward(
            p, cfg, torch.tensor([7], device=device), k, v,
            torch.tensor([16], device=device), attn=attn)
        outs.append((pre.cpu(), dec.cpu()))
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_sampler_scan_repeats_on_card(dev):
    """The sampler's prefix sum on the card (the fixed-order kernel) gives
    the same bits on every call (torch.cumsum on a CUDA float tensor need
    not), and agrees with the CPU's sequential sum to float32 rounding."""
    from qwen3_tpu_torch.runtime.sampler import cumsum_last

    rng = np.random.default_rng(5)
    p = rng.random((1, 151936)).astype(np.float32)
    x = torch.from_numpy(p / p.sum())
    first = cumsum_last(x.to(dev))
    for _ in range(20):
        assert torch.equal(cumsum_last(x.to(dev)), first)
    assert (first.cpu() - torch.cumsum(x, dim=-1)).abs().max() <= 1e-6


@pytest.mark.parametrize("n", [512, 4099, 151936])
def test_sampler_order_kernels_match_plain(dev, n):
    """The sampler's fixed-order sums (csrc/sampler.cu) bit for bit against
    their plain versions in the same order, at B 1, 4, 8 and 64 (n 4099:
    the scalar loads of a width that is not a multiple of 4), one launch a
    call counted; each row the same bits at every B; the first 64 sums of
    the full scan equal the 64-value scan's."""
    from qwen3_tpu_torch.ops.cuda import sampler as cs

    rng = np.random.default_rng(n)
    p = rng.random((64, n)).astype(np.float32) ** 4
    x = torch.from_numpy(p / p.sum(axis=-1, keepdims=True)).to(dev)
    wide_sum, wide_scan = cs.softmax_sum(x), cs.prefix_sum(x)
    for b in (1, 4, 8, 64):
        xb = x[:b].contiguous()
        cs.reset_launches()
        got_sum, got_scan = cs.softmax_sum(xb), cs.prefix_sum(xb)
        torch.cuda.synchronize()
        assert cs.LAUNCHES == {"softmax_sum": 1, "prefix_sum": 1}
        assert torch.equal(got_sum, cs.softmax_sum_ordered(xb))
        assert torch.equal(got_scan, cs.cumsum_ordered(xb))
        assert torch.equal(got_sum, wide_sum[:b])
        assert torch.equal(got_scan, wide_scan[:b])
    assert torch.equal(cs.prefix_sum(x[:, :64].contiguous()),
                       wide_scan[:, :64])


def test_sample_tokens_on_card_match_cpu(dev):
    """sample_tokens on the card against its CPU run at vocabulary 151936:
    the top-64 fast path, the full scan, and the healed mass with its
    fallback index (chip_smoke.check_sampler states the cases and the
    bound)."""
    import chip_smoke

    report = chip_smoke.check_sampler(torch)
    assert report["top-64 fast path"] == 0
    assert report["healed mass, top-64"] == 0
    assert report["healed mass, full scan"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_rows_matches_plain_on_card(dev, dtype):
    """One launch writes every slot's row at its own position, duplicate
    and edge positions included, bit-equal to the indexed assignment (bf16
    rounds to nearest even in both); every other row unchanged."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    L, B, S, KV, D = 3, 8, 16, 2, 64
    rng = np.random.default_rng(0)
    cache = torch.from_numpy(rng.standard_normal((L, B, S, KV, D)).astype(
        np.float32)).to(dev).to(dtype)
    rows = torch.from_numpy(rng.standard_normal((B, KV, D)).astype(
        np.float32)).to(dev)
    positions = torch.tensor([0, 3, 3, S - 1, 7, 0, S - 1, 5], device=dev)
    for layer in (0, L - 1):
        kw.reset_launches()
        got = kw.kv_write_rows(cache.clone(), rows, layer, positions)
        want = kw.kv_write_rows_plain(cache.clone(), rows, layer, positions)
        torch.cuda.synchronize()
        assert kw.LAUNCHES["kv_write"] == 1
        assert torch.equal(got, want)
        keep = torch.ones(L, B, S, dtype=torch.bool, device=dev)
        keep[layer, torch.arange(B, device=dev), positions] = False
        assert torch.equal(got[keep], cache[keep])


def _kernel_launches(fn, tmp_path):
    """The kernels fn() puts on the card, by torch.profiler's kernel events
    (its Chrome trace's "kernel" category; copies are not kernels). The
    host sleeps a little on both sides of fn inside the window: the
    profiler drops device events it places outside its window, which a
    window of one short kernel can miss."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_rows_position_dtypes_on_card(dev, tmp_path, dtype,
                                               pos_dtype):
    """int32 and int64 positions on the card (edge, duplicate and stray
    ones, which both versions clamp), read as stored: bit-equal to the plain
    version, every row it did not write unchanged, and one kernel a call
    (the wrapper makes no cast or clamp of its own), at qwen3-0.6b's row of
    8 x 128 values and at a row of 6 values (the scalar path)."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    for (L, B, S, KV, D) in ((2, 64, 32, 8, 128), (2, 5, 8, 3, 2)):
        rng = np.random.default_rng(B)
        cache = torch.from_numpy(rng.standard_normal(
            (L, B, S, KV, D)).astype(np.float32)).to(dev).to(dtype)
        rows = torch.from_numpy(rng.standard_normal((B, KV, D)).astype(
            np.float32)).to(dev)
        pos = rng.integers(0, S, B)
        pos[:4] = [0, S - 1, 3, 3]
        pos[-1] = S + 5
        positions = torch.tensor(pos, dtype=pos_dtype, device=dev)
        clamped = positions.long().clamp(0, S - 1)
        for layer in (0, L - 1):
            got = cache.clone()
            kw.reset_launches()
            names = _kernel_launches(
                lambda: kw.kv_write_rows(got, rows, layer, positions),
                tmp_path)
            assert kw.LAUNCHES["kv_write"] == 1
            assert len(names) == 1 and "kv_write_rows_kernel" in names[0], \
                names
            want = kw.kv_write_rows_plain(cache.clone(), rows, layer,
                                          positions)
            assert torch.equal(got, want)
            keep = torch.ones(L, B, S, dtype=torch.bool, device=dev)
            keep[layer, torch.arange(B, device=dev), clamped] = False
            assert torch.equal(got[keep], cache[keep])


def test_kv_write_rows_refuses_on_card(dev):
    """Other cache dtypes raise, and so do rows on another device than the
    cache (a CUDA tensor meeting a CPU one, either way round)."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    rows = torch.zeros(2, 1, 8, device=dev)
    with pytest.raises(TypeError):
        kw.kv_write_rows(torch.zeros(1, 2, 4, 1, 8, dtype=torch.int8,
                                     device=dev), rows, 0, [0, 1])
    with pytest.raises(ValueError):
        kw.kv_write_rows(torch.zeros(1, 2, 4, 1, 8, device=dev), rows.cpu(),
                         0, [0, 1])
    with pytest.raises(ValueError):
        kw.kv_write_rows(torch.zeros(1, 2, 4, 1, 8), rows, 0, [0, 1])


# (n, G): one and two 512-wide k-tiles, w2's six, the whole-axis fallback at
# n = 768, and the tiny preset's G = 32
UNTILED = [(512, 64), (1024, 64), (3072, 64), (768, 64), (128, 32)]


def _untiled_inputs(seed, lead, n, d, g, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(lead + (n,)).astype(
        np.float32)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (n // g, d)))).astype(np.float32)).to(dev)
    return x, wq, ws


@pytest.mark.parametrize("lead", [(1,), (8,), (9,), (2, 33)])
@pytest.mark.parametrize("n,g", UNTILED)
def test_q8q8_untiled_matches_plain_on_card(dev, lead, n, g):
    """q8_q8_matmul_pallas on [n, d] weights, bit for bit: the k-tiles
    split across blocks (small b) and walked by one block (b = 66), the
    8-row and the 64-row blocks."""
    from qwen3_tpu_torch.ops.q8 import quantize_act

    x, wq, ws = _untiled_inputs(n + len(lead), lead, n, 200, g, dev)
    xq, xs = quantize_act(x, g)
    tq.reset_launches()
    got = tq.q8_q8_matmul_pallas(xq, xs, wq, ws, g)
    want = tq.q8_q8_matmul_pallas_plain(xq, xs, wq, ws, g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["q8q8_pallas"] == 1
    assert got.shape == lead + (200,)
    assert torch.equal(got, want)


# (n, G) of the route tests: G 16 to 128, several k-tiles each
Q8Q8_ROUTES = [(512, 16), (768, 32), (1024, 64), (3072, 64), (1024, 128)]


@pytest.mark.parametrize("d", [196, 200, 256])
@pytest.mark.parametrize("n,g", Q8Q8_ROUTES)
def test_q8q8_untiled_routes_on_card(dev, n, g, d):
    """q8_q8_matmul_pallas at b = 1, 2, 3, 8, 9, 64 and 512, one launch a
    call, bit-equal to its plain version; each row equal to the same row at
    b = 512, and the b = 512 call equal to q8_q8_matmul_tiled on the
    transposed weights (row 1's kernel). Every route gives those bits: the
    GEMV (b <= 4), the MMA tile path unsplit, split as planned and split a
    k-tile a block. d = 196 and 200 take 4-byte weight copies, 256 16-byte
    ones."""
    x, wq, ws = _untiled_inputs(n + g + d, (512,), n, d, g, dev)
    xq, xs = quantize_act(x, g)
    wide = tq.q8_q8_matmul_pallas(xq, xs, wq, ws, g)
    torch.cuda.synchronize()
    assert torch.equal(wide, tq.q8_q8_matmul_pallas_plain(xq, xs, wq, ws, g))
    assert torch.equal(wide, tq.q8_q8_matmul_tiled(
        xq, xs, wq.T.contiguous(), ws.T.contiguous(), g))
    nt = n // tq.pick_tile(n, 8 * g, 512)
    for b in (1, 2, 3, 8, 9, 64, 512):
        xb, sb = xq[:b].contiguous(), xs[:b].contiguous()
        tq.reset_launches()
        got = tq.q8_q8_matmul_pallas(xb, sb, wq, ws, g)
        torch.cuda.synchronize()
        assert tq.LAUNCHES["q8q8_pallas"] == 1
        assert torch.equal(got, tq.q8_q8_matmul_pallas_plain(xb, sb, wq, ws,
                                                             g)), b
        assert torch.equal(got, wide[:b]), b
        shape, splits = tq.plan_q8q8(b, n, d, g)
        routes = [(False, shape, s) for s in {1, splits, nt}]
        if tq.untiled_gemv_fits(b, n, g):
            routes.append((True, 0, 1))
        for gemv, sh, sp in routes:
            got = tq.q8_q8_untiled_launch(xb, sb, wq, ws, g, 512, gemv, sh, sp)
            torch.cuda.synchronize()
            assert torch.equal(got, wide[:b]), (b, gemv, sh, sp)


@pytest.mark.parametrize("postscale", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(1,), (8,), (2, 33)])
@pytest.mark.parametrize("n,g", UNTILED)
def test_q8_untiled_matches_plain_on_card(dev, lead, n, g, cdt, postscale):
    """q8_matmul_pallas on [n, d] weights within 1e-5 * max|plain|: the
    kernel sums each dot as an fmaf chain in k order, torch.matmul in its
    own order (products of bf16 values are exact in fp32, so bf16 differs
    by the same sums' order only)."""
    x, wq, ws = _untiled_inputs(n * 3 + len(lead), lead, n, 196, g, dev)
    for xin in (x, x.to(torch.bfloat16)):
        tq.reset_launches()
        got = tq.q8_matmul_pallas(xin, wq, ws, g, compute_dtype=cdt,
                                  postscale=postscale)
        want = tq.q8_matmul_pallas_plain(xin, wq, ws, g, compute_dtype=cdt,
                                         postscale=postscale)
        torch.cuda.synchronize()
        assert tq.LAUNCHES["pallas"] == 1
        assert got.shape == lead + (196,)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("d", [196, 256])
@pytest.mark.parametrize("postscale", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,g", UNTILED + [(1024, 128), (512, 16)])
def test_untiled_gemv_rows_on_card(dev, n, g, cdt, postscale, d):
    """q8_matmul_pallas's GEMV (b <= 8) at b = 1, 2, 5 and 8, within 1e-5 *
    max|plain|, one launch a call; each row equal, bit for bit, to the same
    row run alone and to the same row in a 9-row call (the tile kernel):
    both sum each k-tile as one fmaf chain in k order and the tiles in
    order. d = 196 takes 4-byte weight copies, 256 16-byte ones."""
    x, wq, ws = _untiled_inputs(n + g + d, (9,), n, d, g, dev)
    kw = dict(compute_dtype=cdt, postscale=postscale)
    tile = tq.q8_matmul_pallas(x, wq, ws, g, **kw)
    alone = [tq.q8_matmul_pallas(x[r:r + 1].contiguous(), wq, ws, g, **kw)
             for r in range(8)]
    for b in (1, 2, 5, 8):
        xb = x[:b].contiguous()
        tq.reset_launches()
        got = tq.q8_matmul_pallas(xb, wq, ws, g, **kw)
        want = tq.q8_matmul_pallas_plain(xb, wq, ws, g, **kw)
        torch.cuda.synchronize()
        assert tq.LAUNCHES["pallas"] == 1
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), b
        assert torch.equal(got, tile[:b]), b
        for r in range(b):
            assert torch.equal(got[r], alone[r][0]), (b, r)


# (n, G) of the tile kernel's routes: G 16 to 512, one to six k-tiles
TILE_ROUTES = [(1024, 16), (768, 32), (1024, 64), (3072, 64), (1024, 128),
               (2048, 256), (1024, 512)]


@pytest.mark.parametrize("d", [196, 256])
@pytest.mark.parametrize("n,g", TILE_ROUTES)
def test_untiled_tile_routes_on_card(dev, n, g, d):
    """q8_matmul_pallas past 8 rows (the tile kernel) at b = 9, 64, 65 and
    512, in f32 and bf16, pre- and post-scaled, one launch a call on its
    planned route and within 1e-5 * max|plain|; every route forced (every
    tile shape, each split that divides the k-tiles): each row equal bit
    for bit to the same row on every route and at every b, and the first 8
    rows to the GEMV's (both run each (row, column, k-tile) sum as one fmaf
    chain in k order, the tiles in order). d = 196 leaves a ragged column
    block."""
    x, wq, ws = _untiled_inputs(n * 5 + g + d, (512,), n, d, g, dev)
    nt = n // tq.pick_tile(n, 8 * g, 512)
    splits = [s for s in range(1, nt + 1) if nt % s == 0]
    for cdt in (torch.float32, torch.bfloat16):
        for post in (False, True):
            kw = dict(compute_dtype=cdt, postscale=post)
            ref = tq.q8_untiled_launch(x, wq, ws, g, 512, cdt, post, False,
                                       1, 1)
            want = tq.q8_matmul_pallas_plain(x, wq, ws, g, **kw)
            gemv = tq.q8_untiled_launch(x[:8].contiguous(), wq, ws, g, 512,
                                        cdt, post, True)
            torch.cuda.synchronize()
            label = (cdt, post)
            assert (ref - want).abs().max() <= 1e-5 * want.abs().max(), label
            assert torch.equal(gemv, ref[:8]), label
            for b in (9, 64, 65, 512):
                xb = x[:b].contiguous()
                tq.reset_launches()
                got = tq.q8_matmul_pallas(xb, wq, ws, g, **kw)
                torch.cuda.synchronize()
                assert tq.LAUNCHES["pallas"] == 1, (label, b)
                assert torch.equal(got, ref[:b]), (label, b)
                for shape in range(len(tq.UNTILED_TILE_SHAPES)):
                    for sp in splits:
                        got = tq.q8_untiled_launch(xb, wq, ws, g, 512, cdt,
                                                   post, False, shape, sp)
                        torch.cuda.synchronize()
                        assert torch.equal(got, ref[:b]), (label, b, shape,
                                                           sp)


def test_untiled_tile_refuses_a_bad_route(dev):
    """A split that does not divide the k-tiles, an unknown shape and the
    GEMV past 8 rows raise."""
    x, wq, ws = _untiled_inputs(1, (16,), 3072, 64, 64, dev)
    with pytest.raises(ValueError, match="split"):
        tq.q8_untiled_launch(x, wq, ws, 64, 512, torch.float32, False, False,
                             1, 4)
    with pytest.raises(ValueError, match="shape"):
        tq.q8_untiled_launch(x, wq, ws, 64, 512, torch.float32, False, False,
                             len(tq.UNTILED_TILE_SHAPES), 1)
    with pytest.raises(ValueError, match="GEMV"):
        tq.q8_untiled_launch(x, wq, ws, 64, 512, torch.float32, False, True)


def test_untiled_refuse_on_card(dev):
    """d % 4 != 0, a CPU weight beside CUDA activations, and a compute
    dtype other than f32 and bf16 raise."""
    from qwen3_tpu_torch.ops.q8 import quantize_act

    x, wq, ws = _untiled_inputs(0, (2,), 128, 64, 32, dev)
    xq, xs = quantize_act(x, 32)
    with pytest.raises(ValueError):
        tq.q8_q8_matmul_pallas(xq, xs, wq[:, :62].contiguous(),
                               ws[:, :62].contiguous(), 32)
    with pytest.raises(ValueError):
        tq.q8_q8_matmul_pallas(xq, xs, wq.cpu(), ws.cpu(), 32)
    with pytest.raises(ValueError):
        tq.q8_matmul_pallas(x, wq, ws, 32, compute_dtype=torch.float16)


@pytest.mark.parametrize("shape", [(3, 512, 1024), (2, 384, 2560),
                                   (2, 256, 768)])
def test_pure_read_matches_plain_on_card(dev, shape):
    """Both pure-read kernels give the plain checksum at every layer and
    n_buf, each call one launch; the manual ring needs tk <= 512, so the
    n = 768 case (tk = 768, the whole axis) runs the GEMV walk only."""
    from qwen3_tpu_torch.tools import probe_dma as pd

    rng = np.random.default_rng(shape[2])
    w = torch.from_numpy(rng.integers(-128, 128, shape).astype(
        np.int8)).to(dev)
    for layer in range(shape[0]):
        want = pd.pure_read_plain(w, layer)
        pd.reset_launches()
        got = pd.pure_read_stacked(w, layer)
        torch.cuda.synchronize()
        assert pd.LAUNCHES["pure_read_stacked"] == 1
        assert torch.equal(got, want)
        if shape[2] == 768:
            with pytest.raises(ValueError):
                pd.pure_read_manual(w, layer, 2)
            continue
        for n_buf in pd.N_BUFS:
            got = pd.pure_read_manual(w, layer, n_buf)
            torch.cuda.synchronize()
            assert torch.equal(got, want), n_buf
        assert pd.LAUNCHES["pure_read_manual"] == len(pd.N_BUFS)


# -- the Q8_0 x Q8_0 tile path (b > 1) on the int8 tensor cores -------------

TILE_B = (2, 8, 17, 63, 64, 65, 512)


@pytest.mark.parametrize("b", TILE_B)
@pytest.mark.parametrize("n,g", [(1024, 16), (1024, 32), (1024, 64),
                                 (1024, 128), (3072, 32), (3072, 64),
                                 (3072, 128), (2048, 256), (1024, 512)])
def test_tile_path_matches_plain_on_card(dev, b, n, g):
    """The MMA tile path bit for bit at every tile shape the planner picks
    (16 to 64 rows, k-split or not), every group size (G >= 256: dots past
    2^22, converted by the slower exact instruction), a ragged d and the
    stacked last layer; the classifier form at the same shapes."""
    d, layers = 200, 3
    xq, xs, wq, ws = _inputs(7 * b + n + g, b, n, d, g, layers, dev)
    tq.reset_launches()
    got = tq.q8_q8_matmul_stacked(xq, xs, wq, ws, layers - 1, g)
    tiled = tq.q8_q8_matmul_tiled(xq, xs, wq[0], ws[0], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked"] == 1 and tq.LAUNCHES["tiled"] == 1
    assert torch.equal(got, tq.q8q8_matmul_plain(xq, xs, wq[layers - 1],
                                                 ws[layers - 1], g))
    assert torch.equal(tiled, tq.q8q8_matmul_plain(xq, xs, wq[0], ws[0], g))


@pytest.mark.parametrize("n,g,d", [(96, 32, 72), (48, 16, 40), (640, 64, 8)])
def test_tile_path_ragged_k_on_card(dev, n, g, d):
    """k not a multiple of the 64-byte stage, and fewer columns than a tile:
    the stages past the matrix load zeros and add no group."""
    for b in (2, 33, 130):
        xq, xs, wq, ws = _inputs(b + n, b, n, d, g, 1, dev)
        got = tq.q8_q8_matmul_tiled(xq, xs, wq[0], ws[0], g)
        torch.cuda.synchronize()
        assert torch.equal(got, tq.q8q8_matmul_plain(xq, xs, wq[0], ws[0],
                                                     g))


@pytest.mark.parametrize("n,d", [(1024, 4096), (2048, 1024), (3072, 1024)])
def test_tile_path_rows_do_not_depend_on_the_batch(dev, n, d):
    """Row r of a b = 512 call equals, bit for bit, the same row alone (the
    b = 1 GEMV) and within every smaller batch: each tile shape and k-split
    computes a row alone in the same order."""
    xq, xs, wq, ws = _inputs(n + d, 512, n, d, 64, 1, dev)
    wide = tq.q8_q8_matmul_tiled(xq, xs, wq[0], ws[0], 64)
    for b in (1, 2, 8, 17, 65, 256):
        got = tq.q8_q8_matmul_tiled(xq[:b].contiguous(), xs[:b].contiguous(),
                                    wq[0], ws[0], 64)
        torch.cuda.synchronize()
        assert torch.equal(got, wide[:b])
    for r in (0, 100, 511):
        one = tq.q8_q8_matmul_tiled(xq[r:r + 1].contiguous(),
                                    xs[r:r + 1].contiguous(), wq[0], ws[0],
                                    64)
        torch.cuda.synchronize()
        assert torch.equal(one[0], wide[r])


# -- the one-launch decode kernel ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_repeats_and_leaves_counters_zero_on_card(dev, dtype):
    """Two calls equal bit for bit at positions 0, 255, 256, 8191 and 32767
    of a 32768-row cache, with `live` covering them and below them (the
    kernel then reads the rows below `live` only, as the plain version
    does); two calls back to back on one stream leave every completion
    counter at zero."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    s, h, kv, d = 32768, 16, 8, 128
    k, v, ks, vs = _flash_cache(11, 1, s, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, h, d)).astype(np.float32)).to(dev)
    for p in (0, 255, 256, 8191, 32767):
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        for live in (p + 1, max(1, p // 2)):
            first = fd.flash_decode_gqa(q, k, v, pos, ks, vs, live=live)
            again = fd.flash_decode_gqa(q, k, v, pos, ks, vs, live=live)
            want = fd.flash_decode_plain(q, k, v, pos, ks, vs, live=live)
            torch.cuda.synchronize()
            assert torch.equal(first, again)
            _flash_close(first, want)
            # the buffer the kernel used (the wrapper asks with q.device)
            counters = fd.decode_counters(q.device, h)
            assert fd.decode_counters(dev, 1) is counters
            assert not counters.any()


def test_decode_counters_stay_zero_across_kernels_on_card(dev):
    """Flash decode, two-segment and batched decode back to back on one
    stream, at several head groups (M = 2, 4, 8): the counters end at 0
    and each output repeats."""
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    for h, kv in ((16, 8), (16, 4), (16, 2)):
        b, s, d = 3, 1024, 128
        k, v, ks, vs = _flash_cache(h, b, s, kv, d, "int8", dev)
        sk, sv, sks, svs = _flash_cache(h + 1, b, 32, kv, d, "int8", dev)
        q = torch.from_numpy(np.random.default_rng(h).standard_normal(
            (b, h, d)).astype(np.float32)).to(dev)
        pos = torch.tensor([5, 700, 1023], dtype=torch.int32, device=dev)
        off = torch.tensor([0, 31, 9], dtype=torch.int32, device=dev)
        runs = []
        for _ in range(2):
            runs.append((
                fd.flash_decode_gqa(q, k, v, pos, ks, vs),
                fd.flash_decode_gqa_two_segment(q, k, v, sk, sv, pos, off,
                                                ks, vs, sks, svs),
                *bd.batched_decode_partial(q, k[None], v[None], 0, pos,
                                           ks[None], vs[None], bucket=None,
                                           fast=True)))
        torch.cuda.synchronize()
        counters = fd.decode_counters(q.device, b * h)
        assert fd.decode_counters(dev, 1) is counters
        assert not counters.any()
        for a, c in zip(*runs):
            assert torch.equal(a, c)
        _flash_close(runs[0][0], fd.flash_decode_plain(q, k, v, pos, ks, vs))


def test_decode_counters_are_per_stream_on_card(dev):
    """Each stream has its own counter buffer: a call on a side stream
    uses (and leaves at zero) a buffer that is not the default stream's,
    and gives the default stream's bits."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s, h, kv, d = 2, 4096, 16, 8, 128
    k, v, ks, vs = _flash_cache(31, b, s, kv, d, "int8", dev)
    q = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    pos = torch.tensor([100, 4095], dtype=torch.int32, device=dev)
    want = fd.flash_decode_gqa(q, k, v, pos, ks, vs)
    main = fd.decode_counters(dev, 1)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = fd.flash_decode_gqa(q, k, v, pos, ks, vs)
        side_counters = fd.decode_counters(q.device, b * h)
    torch.cuda.synchronize()
    assert side_counters is not main
    assert side_counters.data_ptr() != main.data_ptr()
    assert torch.equal(got, want)
    assert not side_counters.any() and not main.any()


def test_batched_slot_does_not_depend_on_batch_or_bucket_on_card(dev):
    """A slot's (acc, m, l) are the same bits alone (B = 1, the least
    bucket) and among 7 others (B = 8, buckets 640 and 1152)."""
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd

    B, s, h, kv, d = 8, 1152, 16, 8, 128
    k, v, ks, vs = (t.reshape(1, B, *t.shape[1:])
                    for t in _flash_cache(21, B, s, kv, d, "int8", dev))
    q = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (B, h, d)).astype(np.float32)).to(dev)
    lims = [0, 1, 255, 256, 257, 600, 640, 1100]
    lim = torch.tensor(lims, dtype=torch.int32, device=dev)
    for fast in (False, True):
        full = {bucket: bd.batched_decode_partial(q, k, v, 0, lim, ks, vs,
                                                  bucket=bucket, fast=fast)
                for bucket in (1152, None)}
        mid = bd.batched_decode_partial(q[:7], k[:, :7].contiguous(),
                                        v[:, :7].contiguous(), 0, lim[:7],
                                        ks[:, :7].contiguous(),
                                        vs[:, :7].contiguous(), bucket=640,
                                        fast=fast)
        for i, n in enumerate(lims):
            alone = bd.batched_decode_partial(
                q[i:i + 1], k[:, i:i + 1].contiguous(),
                v[:, i:i + 1].contiguous(), 0, lim[i:i + 1].clone(),
                ks[:, i:i + 1].contiguous(), vs[:, i:i + 1].contiguous(),
                bucket=max(n, 1), fast=fast)
            torch.cuda.synchronize()
            for a, f, g in zip(alone, full[1152], full[None]):
                assert torch.equal(a[0], f[i]) and torch.equal(a[0], g[i])
            if i < 7:
                for a, m_ in zip(alone, mid):
                    assert torch.equal(a[0], m_[i])


# -- the fixed-order norm kernel ----------------------------------------------

# the QK-norm's head_dim, the model dims of qwen3-0.6b, 4b and 8b, and two
# ragged widths (the scalar path, one warp and 128 threads a row)
NORM_WIDTHS = (128, 1024, 2560, 4096, 130, 1030)


def _norm_rows(seed, rows, n, dtype, dev):
    """Rows of very different scales, and norm weights 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) * np.exp(rng.uniform(-4, 4, (rows, 1)))
    w = 1 + 0.1 * rng.standard_normal(n)
    return (torch.from_numpy(x.astype(np.float32)).to(dev).to(dtype),
            torch.from_numpy(w.astype(np.float32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", NORM_WIDTHS)
def test_norm_kernel_rows_on_card(dev, n, dtype):
    """rms_inv and rmsnorm on the card, one launch a call: rms_inv bit-equal
    to rms_inv_ordered (the kernel's order in plain ops, on the card) and
    within NORM_RTOL of the torch.mean chain; w * (x * rms_inv(x)) equal to
    rmsnorm(x, w) bit for bit, and rmsnorm within 2 NORM_RTOL of the plain
    chain (plus one bf16 rounding step in bf16); a row's bits the same at b
    = 1, 8 and 512 and alone."""
    from qwen3_tpu_torch.ops.cuda import norms as cn

    x_all, w = _norm_rows(n, 512, n, dtype, dev)
    cn.reset_launches()
    inv_all = tq_norms.rms_inv(x_all)
    out_all = tq_norms.rmsnorm(x_all, w)
    torch.cuda.synchronize()
    assert cn.LAUNCHES == dict(dict.fromkeys(cn.LAUNCHES, 0), rmsnorm=1,
                               rms_inv=1)
    assert inv_all.shape == (512, 1) and out_all.dtype == dtype
    assert torch.equal(inv_all, cn.rms_inv_ordered(x_all))
    plain = tq_norms.rms_inv_plain(x_all)
    assert ((inv_all - plain).abs() / plain).max() <= cn.NORM_RTOL
    xf = x_all.float()
    assert torch.equal(out_all, (w * (xf * inv_all)).to(dtype))
    ref = tq_norms.rmsnorm_plain(x_all, w).float()
    tol = 2 * cn.NORM_RTOL * ref.abs()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.abs()   # one bf16 step
    assert ((out_all.float() - ref).abs() <= tol).all()
    for b in (1, 8):
        x = x_all[:b].contiguous()
        assert torch.equal(tq_norms.rms_inv(x), inv_all[:b]), b
        assert torch.equal(tq_norms.rmsnorm(x, w), out_all[:b]), b
    for r in (0, 7, 511):
        assert torch.equal(tq_norms.rms_inv(x_all[r]), inv_all[r]), r
        assert torch.equal(tq_norms.rmsnorm(x_all[r], w), out_all[r]), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_kernel_on_qk_views_on_card(dev, dtype):
    """The q and k heads sliced from a qwen3-0.6b qkv output (16 + 8 + 8
    heads of 128) normalize in place as views, one launch each, equal to
    their contiguous copies and to the same rows in any batch."""
    from qwen3_tpu_torch.ops.cuda import norms as cn

    B, T, H, KV, D = 2, 65, 16, 8, 128
    flat, w = _norm_rows(7, B * T, (H + 2 * KV) * D, dtype, dev)
    qkv = flat.reshape(B, T, -1)
    wd = w[:D].contiguous()
    for lo, heads in ((0, H), (H * D, KV)):
        view = qkv[..., lo:lo + heads * D].reshape(B, T, heads, D)
        cn.reset_launches()
        got = tq_norms.rmsnorm(view, wd)
        inv = tq_norms.rms_inv(view)
        torch.cuda.synchronize()
        assert cn.LAUNCHES == dict(dict.fromkeys(cn.LAUNCHES, 0), rmsnorm=1,
                                   rms_inv=1)
        assert got.is_contiguous() and got.shape == view.shape
        assert torch.equal(got, tq_norms.rmsnorm(view.contiguous(), wd))
        assert torch.equal(inv, tq_norms.rms_inv(view.contiguous()))
        one = tq_norms.rmsnorm(view[1, 64:65].contiguous(), wd)
        assert torch.equal(one, got[1, 64:65])


def test_norm_refuses_on_card(dev):
    """Weights on the CPU beside CUDA rows, and a layout the kernel does not
    walk, raise."""
    x = torch.zeros(4, 6, 8, 16, device=dev)
    with pytest.raises(ValueError):
        tq_norms.rmsnorm(x, torch.ones(16))
    with pytest.raises(ValueError):
        tq_norms.rms_inv(x[::2, :, :4])
    with pytest.raises(ValueError):
        tq_norms.rms_inv(torch.zeros(16, 4, device=dev).T)


# -- the norm folds -----------------------------------------------------------

# widths of the add folds: NORM_WIDTHS and one past the 4096 values a row's
# threads hold in registers (its later chunks read again)
FOLD_WIDTHS = NORM_WIDTHS + (6000,)
# head widths of qk_norm_rope: qwen3's 128, a narrower and a ragged one, and
# heads of 128 threads (past 1024) up to the widest
QK_WIDTHS = (128, 64, 130, 2560, 4096)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FOLD_WIDTHS)
def test_fold_add_kernels_on_card(dev, n, dtype):
    """add_rmsnorm and add_rms_inv on the card, one launch a call, bit-equal
    to their chain in plain ops on the card (x + y, then rmsnorm_ordered /
    rms_inv_ordered, the norm kernel's order) at b = 512, 8 and 1; a row's
    bits the same at every b."""
    from qwen3_tpu_torch.ops.cuda import norms as cn

    x_all, w = _norm_rows(n, 512, n, dtype, dev)
    y_all = _norm_rows(n + 1, 512, n, dtype, dev)[0]
    wide = None
    for b in (512, 8, 1):
        x, y = x_all[:b].contiguous(), y_all[:b].contiguous()
        cn.reset_launches()
        s, h = tq_norms.add_rmsnorm(x, y, w)
        s2, inv = tq_norms.add_rms_inv(x, y)
        torch.cuda.synchronize()
        assert cn.LAUNCHES == dict(dict.fromkeys(cn.LAUNCHES, 0),
                                   add_rmsnorm=1, add_rms_inv=1)
        assert s.dtype == h.dtype == dtype and inv.shape == (b, 1)
        chain = x + y
        assert torch.equal(s, chain) and torch.equal(s2, chain)
        assert torch.equal(h, cn.rmsnorm_ordered(chain, w))
        assert torch.equal(inv, cn.rms_inv_ordered(chain))
        if wide is None:
            wide = (h, inv)
        assert torch.equal(h, wide[0][:b]) and torch.equal(inv, wide[1][:b])


def _qk_on_card(seed, B, T, H, KV, D, dtype, layout, dev):
    """q and k as views of a qkv output, and the rope tables as the model
    gathers them: [T, 1, half] for a block at position 3, [B, 1, 1, half]
    for a decode step at per-slot positions (T = 1)."""
    from qwen3_tpu_torch.ops.rope import rope_tables

    flat, _ = _norm_rows(seed, B * T, (H + 2 * KV) * D, dtype, dev)
    qkv = flat.reshape(B, T, -1)
    q = qkv[..., :H * D].reshape(B, T, H, D)
    k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D)
    cos, sin = rope_tables(D, 1024, device=dev)
    if layout == "prefill":
        pos = torch.arange(3, 3 + T, device=dev)
        return q, k, cos[pos][:, None, :], sin[pos][:, None, :]
    pos = torch.arange(B, device=dev) * 7 % 1000
    return q, k, cos[pos][:, None, None, :], sin[pos][:, None, None, :]


@pytest.mark.parametrize("layout", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", QK_WIDTHS)
def test_fold_qk_norm_rope_on_card(dev, d, dtype, layout):
    """qk_norm_rope on the card, one launch for q and k, f32 out, bit-equal
    to its chain in plain ops on the card (rmsnorm_ordered, then
    apply_rope) on q/k views of a qkv output and on contiguous heads, at b = 512, 8
    and 1 tokens (decode: slots; prefill: one sequence of b tokens and
    two of 4); a head's bits the same at every b."""
    from qwen3_tpu_torch.ops.cuda import norms as cn
    from qwen3_tpu_torch.ops.rope import apply_rope

    H, KV = (16, 8) if d <= 1024 else (2, 1)
    wq, wk = (_norm_rows(d + i, 1, d, torch.float32, dev)[1]
              for i in (1, 2))
    shapes = ((512, 1), (8, 1), (1, 1)) if layout == "decode" else (
        (1, 512), (1, 8), (1, 1), (2, 4))
    q0, k0, cos0, sin0 = _qk_on_card(d, *shapes[0], H, KV, d, dtype, layout,
                                     dev)
    wide = None
    for B, T in shapes:
        if layout == "decode":
            q, k, cos, sin = q0[:B], k0[:B], cos0[:B], sin0[:B]
        else:
            q = q0[:, :B * T].reshape(B, T, H, d)
            k = k0[:, :B * T].reshape(B, T, KV, d)
            cos, sin = cos0[:T], sin0[:T]
        for qq, kk in ((q, k), (q.contiguous(), k.contiguous())):
            cn.reset_launches()
            gq, gk = tq_norms.qk_norm_rope(qq, kk, wq, wk, cos, sin)
            torch.cuda.synchronize()
            assert cn.LAUNCHES == dict(dict.fromkeys(cn.LAUNCHES, 0),
                                       qk_norm_rope=1)
            assert gq.dtype == gk.dtype == torch.float32
            assert torch.equal(gq, apply_rope(cn.rmsnorm_ordered(qq, wq),
                                              cos, sin))
            assert torch.equal(gk, apply_rope(cn.rmsnorm_ordered(kk, wk),
                                              cos, sin))
        if wide is None:
            wide = (gq, gk)
        elif layout == "decode":          # the first B slots
            assert torch.equal(gq, wide[0][:B])
            assert torch.equal(gk, wide[1][:B])
        elif B == 1:                      # the first T tokens
            assert torch.equal(gq, wide[0][:, :T])
            assert torch.equal(gk, wide[1][:, :T])


def test_fold_refuses_on_card(dev):
    """Weights or tables on the CPU beside CUDA rows, and a head the kernel
    does not take, raise before a launch."""
    x = torch.zeros(4, 16, device=dev)
    with pytest.raises(ValueError):
        tq_norms.add_rmsnorm(x, x, torch.ones(16))
    with pytest.raises(ValueError):
        tq_norms.add_rms_inv(x, x[:, :8])
    q = torch.zeros(1, 2, 4, 16, device=dev)
    w = torch.ones(16, device=dev)
    cos = torch.zeros(2, 1, 8, device=dev)
    with pytest.raises(ValueError):
        tq_norms.qk_norm_rope(q, q, w, w, cos.cpu(), cos.cpu())
    with pytest.raises(ValueError):
        tq_norms.qk_norm_rope(q[..., :15], q[..., :15], w[:15], w[:15],
                              cos, cos)


@pytest.mark.parametrize("n", [512, 151936])
def test_sampler_order_counters_reset_on_card(dev, n):
    """The one-pass sampler kernels leave their counters, tickets and tile
    words zero (the current stream's decode_counters): two back-to-back calls on a stream, and calls on a second
    stream (its own counters), give the same bits as the first call, at B
    1 and 64."""
    from qwen3_tpu_torch.ops.cuda import sampler as cs

    rng = np.random.default_rng(n + 1)
    p = rng.random((64, n)).astype(np.float32) ** 4
    x = torch.from_numpy(p / p.sum(axis=-1, keepdims=True)).to(dev)
    for b in (1, 64):
        xb = x[:b].contiguous()
        first = (cs.softmax_sum(xb), cs.prefix_sum(xb))
        again = (cs.softmax_sum(xb), cs.prefix_sum(xb))
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            other = (cs.softmax_sum(xb), cs.prefix_sum(xb),
                     cs.softmax_sum(xb), cs.prefix_sum(xb))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        want = (cs.softmax_sum_ordered(xb), cs.cumsum_ordered(xb))
        for got in (first, again, other[:2], other[2:]):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
    from qwen3_tpu_torch.ops.cuda.flash_decode import decode_counters

    torch.cuda.synchronize()
    assert not decode_counters(dev, 1).any()


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("case", ["free", "stop", "limit", "emit"])
def test_decode_chunk_equals_host_loop_without_sync_on_card(dev, case,
                                                            attn):
    """The B = 1 chunk (runtime/decode_loop.py::decode_chunk) on the card
    at preset tiny (mode pallas, int8 KV, seeded): no synchronizing call
    between its first step and the read of packed
    (set_sync_debug_mode("error")), and bit-equal to decode_chunk_host,
    the same steps with a host read after each: packed, token, position,
    RNG and every KV row below the position. A free chunk, a stop drawn at
    a later step, the limit without and with emit_at_limit."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.synthetic import synthetic_weights
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.runtime import kvcache
    from qwen3_tpu_torch.runtime.decode_loop import (
        decode_chunk,
        decode_chunk_host,
    )
    from qwen3_tpu_torch.runtime.xorshift import (
        from_device_state,
        to_device_state,
    )

    cfg, rows, pos0, chunk = PRESETS["tiny"], 128, 16, 8
    params = model.init_params(synthetic_weights(cfg, seed=3),
                               mode="pallas", max_seq_len=rows, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, pos0))).to(dev)

    def prefilled():
        k, v = model.init_kv_cache(cfg, 1, rows, "int8", dev)
        model.forward(params, cfg, toks, k, v, 0)
        return k, v

    kw = dict(mode="pallas", chunk=chunk, temperature=0.8, top_p=0.9,
              greedy=False, bos=cfg.vocab_size - 1, eos=cfg.vocab_size - 2,
              emit_at_limit=case == "emit", top_k=64, attn=attn)
    limit = pos0 + 5 if case in ("limit", "emit") else rows
    free = decode_chunk_host(params, cfg, *prefilled(), 7, pos0, limit, 5,
                             **kw)[0]
    if case == "stop":
        ids = free[:int(free[-2])].tolist()
        kw["eos"] = next(t for i, t in enumerate(ids) if i >= 2
                         and t not in ids[:i])
    want, wk, wv, w_tok, w_pos, w_rng = decode_chunk_host(
        params, cfg, *prefilled(), 7, pos0, limit, 5, **kw)
    k, v = prefilled()
    tok = torch.full((1,), 7, dtype=torch.int64, device=dev)
    hi, lo = to_device_state(5, dev)
    # a first chunk makes the per-device constants (ops/q8.py::const)
    decode_chunk(params, cfg, *prefilled(), tok, pos0, limit, hi, lo, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = decode_chunk(params, cfg, k, v, tok, pos0, limit, hi, lo, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got[0].cpu().tolist() == want.tolist()
    assert (int(got[3][0]), int(got[4]), from_device_state(*got[5:])) == (
        w_tok, w_pos, w_rng)
    if case == "stop":
        assert bool(want[-1]) and int(want[-2]) < chunk
    for a, b in zip(kvcache.tensors(got[1]) + kvcache.tensors(got[2]),
                    kvcache.tensors(wk) + kvcache.tensors(wv)):
        assert torch.equal(a[:, :, :w_pos], b[:, :, :w_pos])
