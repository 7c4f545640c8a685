"""The untiled dequant matmul's planner (qwen3_tpu_torch/ops/cuda/
q8_matmul.py::plan_untiled), a pure function of the shapes, at every layer
matrix and the classifier of qwen3-0.6b and qwen3-4b in the [n, d] layout:
b <= 8 takes the GEMV; past it the tile kernel's rows a block and its
k-split (a divisor of the k-tiles, so every split cuts them evenly) leave
the busiest SM the fewest FMAs among the grids that hold enough warps;
at the shapes timed on an H100 the plan is pinned to the fastest route.
Every route runs each row's chains in the same order; the card tests hold
the routes' rows equal (test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402
from qwen3_tpu_torch.tools import untiled_routes  # noqa: E402


def _matrices(name):
    """A preset's matrices in the untiled [n, d] layout: (label, n, d, G)."""
    c = PRESETS[name]
    q = c.n_heads * c.head_dim
    kv = c.n_kv_heads * c.head_dim
    return [("wqkv", c.dim, q + 2 * kv, c.group_size),
            ("wo", q, c.dim, c.group_size),
            ("w13", c.dim, 2 * c.hidden_dim, c.group_size),
            ("w2", c.hidden_dim, c.dim, c.group_size),
            ("cls", c.dim, c.vocab_size, c.group_size)]


CASES = [(m, *mat) for m in ("qwen3-0.6b", "qwen3-4b") for mat in _matrices(m)]


def _tiles(n, g):
    return n // tq.pick_tile(n, 8 * g, 512)


@pytest.mark.parametrize("b", [9, 64, 65, 512])
@pytest.mark.parametrize("model,label,n,d,g", CASES)
def test_plan_untiled_shape_and_split(model, label, n, d, g, b):
    """Past 8 rows the tile kernel: 64 rows a block up to b = 64; a split
    that divides the k-tiles; and no split where the unsplit grid already
    holds UNTILED_SPLIT_WARPS warps (2 x rows threads a block)."""
    gemv, shape, splits = tq.plan_untiled(b, n, d, g)
    assert not gemv
    rows, cols = tq.UNTILED_TILE_SHAPES[shape]
    if b <= 64:
        assert rows == 64
    nt = _tiles(n, g)
    assert 1 <= splits <= nt and nt % splits == 0
    unsplit_warps = -(-d // cols) * -(-b // rows) * rows // 16
    if unsplit_warps >= tq.UNTILED_SPLIT_WARPS:
        assert splits == 1


@pytest.mark.parametrize("b", [1, 2, 5, 8])
@pytest.mark.parametrize("model,label,n,d,g", CASES)
def test_plan_untiled_keeps_decode_on_the_gemv(model, label, n, d, g, b):
    """b <= 8 stays on the GEMV (one launch, no split) at every matrix and
    any SM count."""
    for sms in (16, 132):
        assert tq.plan_untiled(b, n, d, g, sms=sms) == (True, 0, 1)


def test_plan_untiled_at_the_block_shapes():
    """The grids a 512-row prefill block of qwen3-0.6b gets (chip_smoke.py's
    forced routes on an H100: the fastest at wqkv, wo and w2, within 1% of
    it at w13): wqkv and w13 128-row blocks in two splits, wo 128-row
    blocks one a k-tile, w2 64-row blocks one a k-tile (128-row ones leave
    a third of the SMs one block and the rest two), the classifier
    unsplit."""
    got = {label: tq.plan_untiled(512, n, d, g)
           for _, label, n, d, g in CASES[:5]}
    assert got == {"wqkv": (False, 1, 2), "wo": (False, 1, 4),
                   "w13": (False, 1, 2), "w2": (False, 0, 6),
                   "cls": (False, 1, 1)}


# The fastest of every forced route in f32 prescale, timed by
# `python -m qwen3_tpu_torch.tools.untiled_routes --batches 9,64,65,512` on an
# NVIDIA H100 80GB HBM3 at 700 W: (model, b) -> {matrix: (shape, splits)}.
# Only routes the plan takes are pinned; qwen3-4b's w13 at b = 512 is left
# out (the plan's unsplit 128-row grid 1343 us, the 5-way split 1298 us).
TIMED = {
    ("qwen3-0.6b", 9): {"wqkv": (0, 2), "wo": (0, 4), "w13": (0, 2),
                        "w2": (0, 6)},
    ("qwen3-0.6b", 64): {"wqkv": (0, 2), "wo": (0, 4), "w13": (0, 2),
                         "w2": (0, 6)},
    ("qwen3-0.6b", 65): {"wqkv": (0, 2), "wo": (0, 4), "w13": (1, 2),
                         "w2": (0, 6)},
    ("qwen3-4b", 9): {"wqkv": (0, 5), "wo": (0, 8), "w13": (0, 5),
                      "w2": (0, 19)},
    ("qwen3-4b", 64): {"wqkv": (0, 5), "wo": (0, 8), "w13": (0, 5),
                       "w2": (0, 19)},
    ("qwen3-4b", 65): {"wqkv": (1, 5), "wo": (0, 8), "w13": (1, 5),
                       "w2": (1, 19)},
    ("qwen3-4b", 512): {"wqkv": (0, 5), "wo": (1, 8), "w2": (1, 19)},
}


@pytest.mark.parametrize("model,b", sorted(TIMED))
def test_plan_untiled_at_the_timed_shapes(model, b):
    """At qwen3-0.6b's and qwen3-4b's layer matrices the plan takes the
    route that was fastest on the card (TIMED)."""
    mats = {label: (n, d, g) for label, n, d, g in _matrices(model)}
    got = {label: tq.plan_untiled(b, *mats[label])
           for label in TIMED[model, b]}
    assert got == {label: (False, *route)
                   for label, route in TIMED[model, b].items()}


@pytest.mark.parametrize("b", [9, 65, 512])
@pytest.mark.parametrize("model,label,n,d,g", CASES)
def test_route_tool_times_the_planned_route(model, label, n, d, g, b):
    """tools.untiled_routes times every route the plan can take."""
    _, shape, splits = tq.plan_untiled(b, n, d, g)
    assert (shape, splits) in untiled_routes.tile_routes(n, g)


def test_plan_untiled_scales_with_the_sm_count():
    """A card with fewer SMs splits later."""
    assert tq.plan_untiled(512, 1024, 4096, 64, sms=132) == (False, 1, 2)
    assert tq.plan_untiled(512, 1024, 4096, 64, sms=64) == (False, 1, 1)
    assert tq.plan_untiled(64, 2048, 1024, 64, sms=132) == (False, 0, 4)
    assert tq.plan_untiled(64, 2048, 1024, 64, sms=2) == (False, 0, 1)


@pytest.mark.parametrize("block_k", [128, 256, 512, 1024])
def test_plan_untiled_follows_block_k(block_k):
    """The k-tiles follow block_k (tk = _pick_tile(n, 8 G, block_k)), and the
    split divides them at every block_k."""
    for b in (9, 65, 512):
        for _, _, n, d, g in CASES:
            _, _, splits = tq.plan_untiled(b, n, d, g, block_k)
            nt = n // tq.pick_tile(n, 8 * g, block_k)
            assert nt % splits == 0, (b, n, d, block_k)
