"""The grid planners of the Q8_0 matmul kernels (ops/cuda/q8_matmul.py::
plan_q8q8 for the Q8_0 x Q8_0 tile path, unfused and fused at b > 1, and
::plan_untiled for the untiled kernels' route), pure functions of the
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
    """q8_matmul_pallas takes its GEMV at b <= 8 (one launch, no split);
    q8_q8_matmul_pallas, and the dequant kernel above 8 rows, the tile
    kernel, which splits its k-tiles when there are several and its row
    and column blocks fall short of two an SM."""
    gemv, split = tq.plan_untiled(b, n, d, 64)
    assert gemv == (b <= tq.UNTILED_GEMV_ROWS)
    if gemv:
        assert not split
    gemv8, split8 = tq.plan_untiled(b, n, d, 64, gemv=False)
    assert not gemv8
    nt = n // tq.pick_tile(n, 8 * 64, 512)
    blocks = -(-d // 64) * -(-b // (8 if b <= 8 else 64))
    assert split8 == (nt > 1 and blocks < 2 * 132)
    if not gemv:
        assert (gemv, split) == (gemv8, split8)


def test_untiled_plan_scales_with_the_sm_count():
    """The tile kernel's k-split follows the card's SM count; the GEMV's
    route does not depend on it."""
    assert tq.plan_untiled(512, 3072, 1024, 64, sms=132) == (False, True)
    assert tq.plan_untiled(512, 3072, 1024, 64, sms=16) == (False, False)
    assert tq.plan_untiled(1, 3072, 1024, 64, sms=16) == (True, False)


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
