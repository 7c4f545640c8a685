"""The grid planners of the Q8_0 matmul kernels (ops/cuda/q8_matmul.py::
plan_q8q8 for the Q8_0 x Q8_0 tile path, unfused, fused and untiled at b >
1, ::plan_untiled for the untiled dequant kernel's route and
::plan_untiled_q8q8 for the untiled exact one's), pure functions of the
shapes, and the k-split's order on the CPU: the kernel's split grid writes
each k-tile's sum and a second pass adds them in tile order, which must be
the plain version's arithmetic bit for bit. The kernel itself is held to
the plain version on the card (test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402
from qwen3_tpu_torch.ops.q8 import quantize_act  # noqa: E402

# qwen3-0.6b's matrices (n, d) and the CLI's prefill blocks and serving B
MATRICES = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024),
            (1024, 151936)]
BATCHES = [2, 8, 16, 17, 32, 33, 64, 65, 128, 129, 256, 512]


def _tiles(n, g):
    return n // (tq.groups_per_tile(n, g) * g)


def _q8q8_gemv(b, n, d, g=64, sms=132):
    """The untiled exact matmul's GEMV route: up to the crossover, while its
    terms fit, and while the 16-row tile path's blocks would not reach
    UNTILED_Q8Q8_TILE_BLOCKS (where they do, the tile path streams faster
    in one launch)."""
    return (b <= tq.UNTILED_Q8Q8_GEMV_ROWS and tq.untiled_gemv_fits(b, n, g)
            and -(-d // tq.TILE_COLS)
            < tq.UNTILED_Q8Q8_TILE_BLOCKS * sms // 132)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n,d", MATRICES)
def test_plan_holds_the_rows_and_fills_the_card(b, n, d):
    shape, splits = tq.plan_q8q8(b, n, d, 64)
    rows = tq.TILE_ROWS[shape]
    # 16 rows up to 16, 32 up to 64, 64 past it
    assert rows == (16 if b <= 16 else 32 if b <= 64 else 64)
    blocks = -(-d // tq.TILE_COLS) * -(-b // rows)
    nt = _tiles(n, 64)
    assert 1 <= splits <= nt
    if blocks >= tq.SPLIT_BELOW:
        assert splits == 1
    else:
        # as many splits as reach the target, or one a k-tile
        assert splits == nt or blocks * splits >= tq.SPLIT_TARGET
        # the kernel's even cut gives exactly `splits` blocks a tile
        tps = -(-nt // splits)
        assert -(-nt // tps) == splits


def test_plan_at_the_main_path_shapes():
    """The grids qwen3-0.6b's prefill blocks and serving steps get: wo and
    w2 (1024 columns) split their k-tiles at every b up to 512, the
    classifier never does."""
    assert tq.plan_q8q8(8, 1024, 4096, 64) == (0, 2)
    assert tq.plan_q8q8(64, 2048, 1024, 64) == (1, 4)
    assert tq.plan_q8q8(64, 3072, 1024, 64) == (1, 6)
    assert tq.plan_q8q8(512, 1024, 4096, 64) == (2, 1)
    assert tq.plan_q8q8(512, 2048, 1024, 64) == (2, 4)
    assert tq.plan_q8q8(512, 3072, 1024, 64) == (2, 3)
    for b in BATCHES:
        assert tq.plan_q8q8(b, 1024, 151936, 64)[1] == 1


def test_plan_scales_with_the_sm_count():
    """A card with fewer SMs splits later: the thresholds scale with it."""
    assert tq.plan_q8q8(64, 2048, 1024, 64, sms=132)[1] == 4
    assert tq.plan_q8q8(64, 2048, 1024, 64, sms=16)[1] == 1


@pytest.mark.parametrize("b", [1, 2, 5, 8, 9, 64, 512])
@pytest.mark.parametrize("n,d", MATRICES)
def test_untiled_plan_routes_decode_to_the_gemv(b, n, d):
    """q8_matmul_pallas takes its GEMV at b <= 8 (one launch, no split),
    above it the tile kernel (64 rows a block, or past 64 rows 128), which
    splits its k-tiles evenly only when its row and column blocks hold
    fewer than 16 warps an SM; q8_q8_matmul_pallas takes its own GEMV up to
    UNTILED_Q8Q8_GEMV_ROWS (not for the classifier, whose tile blocks fill
    the card) and else
    plan_q8q8's MMA grid (the [d, n] tile path's)."""
    gemv, shape, splits = tq.plan_untiled(b, n, d, 64)
    assert gemv == (b <= tq.UNTILED_GEMV_ROWS)
    nt = n // tq.pick_tile(n, 8 * 64, 512)
    if gemv:
        assert (shape, splits) == (0, 1)
    else:
        rows, cols = tq.UNTILED_TILE_SHAPES[shape]
        warps = -(-d // cols) * -(-b // rows) * rows // 16
        assert nt % splits == 0 and (rows == 64 or b > 64)
        if warps >= tq.UNTILED_SPLIT_WARPS:
            assert splits == 1
    qgemv, shape, splits = tq.plan_untiled_q8q8(b, n, d, 64)
    assert qgemv == _q8q8_gemv(b, n, d)
    assert qgemv == (b <= tq.UNTILED_Q8Q8_GEMV_ROWS and d < 16896)
    if qgemv:
        assert (shape, splits) == (0, 1)
    else:
        assert (shape, splits) == tq.plan_q8q8(b, n, d, 64)


def test_untiled_plan_scales_with_the_sm_count():
    """The tile kernels' k-splits follow the card's SM count; the GEMVs'
    routes do not depend on it."""
    assert tq.plan_untiled(512, 3072, 1024, 64, sms=132) == (False, 0, 6)
    assert tq.plan_untiled(512, 3072, 1024, 64, sms=16) == (False, 1, 1)
    assert tq.plan_untiled(1, 3072, 1024, 64, sms=16) == (True, 0, 1)
    assert tq.plan_untiled_q8q8(512, 3072, 1024, 64, sms=132) == (False, 2, 3)
    assert tq.plan_untiled_q8q8(512, 3072, 1024, 64, sms=16) == (False, 2, 1)
    assert tq.plan_untiled_q8q8(1, 3072, 1024, 64, sms=16) == (True, 0, 1)
    assert tq.plan_untiled_q8q8(1, 1024, 6144, 64, sms=132) == (True, 0, 1)
    assert tq.plan_untiled_q8q8(1, 1024, 6144, 64, sms=16) == (False, 0, 1)


def _model_matrices(name):
    """A preset's five matrices in the untiled [n, d] layout: (n, d)."""
    from qwen3_tpu_torch.config import PRESETS

    c = PRESETS[name]
    q = c.n_heads * c.head_dim
    kv = c.n_kv_heads * c.head_dim
    return [(c.dim, q + 2 * kv), (q, c.dim), (c.dim, 2 * c.hidden_dim),
            (c.hidden_dim, c.dim), (c.dim, c.vocab_size)]


UNTILED_B = [1, 2, 3, 4, 8, 9, 16, 17, 64, 65, 128, 512]


@pytest.mark.parametrize("b", UNTILED_B)
@pytest.mark.parametrize("model", ["qwen3-0.6b", "qwen3-4b"])
def test_untiled_q8q8_plan_at_model_shapes(model, b):
    """At every matrix of qwen3-0.6b and qwen3-4b: the GEMV up to the
    crossover on the matrices whose tile blocks would not fill the card,
    else the tile path with the [d, n] path's row tile, a split that
    divides the k-tiles evenly, and no split where the blocks alone fill
    the card (so the classifier at b = 1 is one launch too)."""
    assert 1 <= tq.UNTILED_Q8Q8_GEMV_ROWS <= tq.UNTILED_GEMV_ROWS
    assert tq.UNTILED_Q8Q8_TILE_BLOCKS >= tq.SPLIT_TARGET
    for n, d in _model_matrices(model):
        gemv, shape, splits = tq.plan_untiled_q8q8(b, n, d, 64)
        assert gemv == _q8q8_gemv(b, n, d)
        if gemv:
            continue
        if b <= tq.UNTILED_Q8Q8_GEMV_ROWS:
            assert splits == 1
        assert tq.TILE_ROWS[shape] == (16 if b <= 16 else 32 if b <= 64
                                       else 64)
        nt = _tiles(n, 64)
        assert 1 <= splits <= nt
        tps = -(-nt // splits)
        assert -(-nt // tps) == splits
        blocks = -(-d // tq.TILE_COLS) * -(-b // tq.TILE_ROWS[shape])
        if blocks >= tq.SPLIT_BELOW:
            assert splits == 1


@pytest.mark.parametrize("sms", [16, 66, 114, 132])
@pytest.mark.parametrize("model", ["qwen3-0.6b", "qwen3-4b"])
def test_untiled_q8q8_plan_at_other_sm_counts(model, sms):
    """A card with fewer SMs splits no more than one with more, and takes
    the GEMV on no matrix that the full card gives the tile path (its
    column threshold scales with the SMs)."""
    for n, d in _model_matrices(model):
        for b in UNTILED_B:
            gemv, shape, splits = tq.plan_untiled_q8q8(b, n, d, 64, sms=sms)
            full = tq.plan_untiled_q8q8(b, n, d, 64)
            assert gemv == _q8q8_gemv(b, n, d, sms=sms)
            assert full[0] or not gemv
            if not gemv and not full[0]:
                assert shape == full[1]
                assert splits <= full[2]
            assert (shape, splits) == ((0, 1) if gemv else tq.plan_q8q8(
                b, n, d, 64, sms=sms))


@pytest.mark.parametrize("block_k", [128, 256, 512, 1024])
def test_untiled_q8q8_plan_follows_block_k(block_k):
    """The k-tiles are _pick_tile(n, 8 G, block_k) wide, so the split counts
    those tiles; a call whose group terms (R x n / G) exceed
    UNTILED_GEMV_MAX_TERMS takes the tile path even at b = 1."""
    for n, d in _model_matrices("qwen3-0.6b"):
        nt = n // tq.pick_tile(n, 8 * 64, block_k)
        for b in UNTILED_B:
            gemv, _shape, splits = tq.plan_untiled_q8q8(b, n, d, 64, block_k)
            assert 1 <= splits <= nt
            if gemv:
                assert b <= tq.UNTILED_Q8Q8_GEMV_ROWS
    g = 16
    n = g * (tq.UNTILED_GEMV_MAX_TERMS + 16)
    assert not tq.untiled_gemv_fits(1, n, g)
    assert not tq.plan_untiled_q8q8(1, n, 64, g, block_k=block_k)[0]
    assert tq.untiled_gemv_fits(1, g * tq.UNTILED_GEMV_MAX_TERMS, g)
    assert not tq.untiled_gemv_fits(2, g * tq.UNTILED_GEMV_MAX_TERMS, g)
    assert tq.untiled_gemv_fits(tq.UNTILED_Q8Q8_GEMV_ROWS, 1024, 64)
    assert not tq.untiled_gemv_fits(tq.UNTILED_Q8Q8_GEMV_ROWS + 1, 1024, 64)


@pytest.mark.parametrize("b", [2, 8, 65])
@pytest.mark.parametrize("n,g", [(2048, 64), (3072, 32), (1024, 128)])
def test_split_tile_sums_in_order_equal_plain(b, n, g):
    """Each k-tile's sum alone (the plain version on that tile's columns:
    0 + acc_t) added in tile order from 0, as the split's second pass adds
    them, equals the plain version over the whole k bit for bit."""
    rng = np.random.default_rng(b + n + g)
    d = 96
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    xq, xs = quantize_act(x, g)
    wq = torch.from_numpy(rng.integers(-127, 128, (d, n)).astype(np.int8))
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random((d, n // g))))
                          .astype(np.float32))
    tk = tq.groups_per_tile(n, g) * g
    out = torch.zeros(b, d)
    for k0 in range(0, n, tk):
        part = tq.q8q8_matmul_plain(xq[:, k0:k0 + tk], xs[:, k0 // g:
                                    (k0 + tk) // g], wq[:, k0:k0 + tk],
                                    ws[:, k0 // g:(k0 + tk) // g], g)
        out = out + part
    assert torch.equal(out, tq.q8q8_matmul_plain(xq, xs, wq, ws, g))
    # and a row's bits do not depend on its batch-mates
    one = tq.q8q8_matmul_plain(xq[-1:], xs[-1:], wq, ws, g)
    assert torch.equal(one[0], out[-1])
