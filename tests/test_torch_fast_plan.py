"""The pallas-fast matmul's route planner (ops/cuda/q8_matmul.py::
plan_fast), a pure function of the shapes: the group split up to
FAST_SPLIT_ROWS rows, above it the tile kernel's shape or the split by the
reckoned time. Every route computes each row alone in the plain version's
order, so the plan picks a speed, never a result; the kernels are held to
the plain version and to each other on the card (test_torch_cuda.py)."""

import pytest

from qwen3_tpu_torch.config import PRESETS
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq
from qwen3_tpu_torch.tools import fast_routes


def _matrices(preset):
    c = PRESETS[preset]
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return {"wqkv": (c.dim, q + 2 * kv), "wo": (q, c.dim),
            "w13": (c.dim, 2 * c.hidden_dim), "w2": (c.hidden_dim, c.dim),
            "classifier": (c.dim, c.vocab_size)}


QWEN3_4B = _matrices("qwen3-4b")
QWEN3_06B = _matrices("qwen3-0.6b")
# the routes measured fastest (or within 3% of it) by tools.fast_routes on
# an NVIDIA H100 80GB HBM3: qwen3-4b's prefill blocks (the bucket is 128
# rows) and its serving decode step at 64 slots
PLANNED_4B = {
    64: {"wqkv": "64x64/4", "wo": "split", "w13": "64x64/1", "w2": "split",
         "classifier": "64x128/1"},
    128: {"wqkv": "64x128/2", "wo": "64x64/4", "w13": "64x128/1",
          "w2": "64x64/4"},
    256: {"wqkv": "64x64/1", "wo": "64x128/2", "w13": "64x128/1",
          "w2": "64x128/2"},
    384: {"wqkv": "64x128/1", "wo": "64x128/2", "w13": "64x128/1",
          "w2": "64x128/2"},
    512: {"wqkv": "64x128/1", "wo": "64x64/1", "w13": "64x128/1",
          "w2": "64x64/1"},
    1024: {"wqkv": "64x128/1", "wo": "64x128/1", "w13": "64x128/1",
           "w2": "64x128/1"},
}


@pytest.mark.parametrize("b,matrix", [(b, m) for b, row in PLANNED_4B.items()
                                      for m in row])
def test_plan_at_qwen3_4b_shapes(b, matrix):
    n, d = QWEN3_4B[matrix]
    route = tq.plan_fast(b, n, d, 64)
    assert fast_routes.route_name(route) == PLANNED_4B[b][matrix]


@pytest.mark.parametrize("b", range(128, 1025, 128))
@pytest.mark.parametrize("matrix", ["wqkv", "wo", "w13", "w2"])
def test_every_qwen3_4b_prefill_block_takes_the_tile(b, matrix):
    """Every prefill block of the 4B (128 to ADMIT_ROWS = 1024 rows), wo
    and w2 at 128 rows among them, runs the tile kernel."""
    n, d = QWEN3_4B[matrix]
    assert tq.plan_fast(b, n, d, 64) != tq.FAST_SPLIT


@pytest.mark.parametrize("b", range(1, tq.FAST_SPLIT_ROWS + 1))
@pytest.mark.parametrize("preset", ["qwen3-0.6b", "qwen3-4b"])
def test_decode_at_eight_rows_or_fewer_keeps_the_split(b, preset):
    for n, d in _matrices(preset).values():
        assert tq.plan_fast(b, n, d, 64) == tq.FAST_SPLIT


@pytest.mark.parametrize("b", [9, 16, 33, 64, 65, 128, 200, 384, 512, 1024])
@pytest.mark.parametrize("n,d", list(QWEN3_06B.values())
                         + list(QWEN3_4B.values()))
def test_plan_takes_the_least_reckoned_time(b, n, d):
    """The route is the tile shape with the least fast_tile_us, unless the
    split's reckoned time is less; either way a route fast_routes times."""
    route = tq.plan_fast(b, n, d, 64)
    assert route in fast_routes.routes()
    times = [tq.fast_tile_us(s, b, n, d)
             for s in range(len(tq.FAST_TILE_SHAPES))]
    split = b * n * d / (tq.FAST_SPLIT_RATE * 132)
    if route == tq.FAST_SPLIT:
        assert split <= min(times)
    else:
        assert times[route] == min(times) and times[route] < split


def test_reckoned_time_follows_the_blocks_an_sm_runs():
    """fast_tile_us: the busiest SM's blocks at that many blocks' rate; a
    shape holding one block an SM runs further blocks in waves."""
    rows, cols, _ = tq.FAST_TILE_SHAPES[0]
    n = 2560
    one = tq.fast_tile_us(0, 64, n, 128 * 132)       # 132 blocks: one an SM
    two = tq.fast_tile_us(0, 64, n, 128 * 133)       # one SM runs two
    assert one == rows * cols * n / tq.FAST_TILE_RATES[0][0]
    assert two == 2 * rows * cols * n / tq.FAST_TILE_RATES[0][1]
    waves = tq.fast_tile_us(3, 64, n, 64 * 132 * 3)  # one block an SM
    assert waves == 3 * 64 * 64 * n / tq.FAST_TILE_RATES[3][0]
    # fewer SMs, as many blocks: no faster
    assert tq.fast_tile_us(0, 512, n, 6144, sms=66) >= tq.fast_tile_us(
        0, 512, n, 6144)


def test_routes_name_every_shape():
    names = [fast_routes.route_name(r) for r in fast_routes.routes()]
    assert names[0] == "split" and len(set(names)) == len(names)
    assert len(names) == 1 + len(tq.FAST_TILE_SHAPES)
