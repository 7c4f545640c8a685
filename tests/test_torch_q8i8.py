"""The pallas-int8 matmul of the PyTorch port (ops/cuda/q8_matmul.py::
q8i8_matmul_plain, which the wrappers run on the CPU) against the JAX
package's Pallas kernels q8i8_matmul_stacked / q8i8_matmul_tiled in
interpret mode, on weights repacked by the JAX package's repack_tiles. The
CUDA kernel against its plain version is in test_torch_cuda.py.

Tolerance 1e-5 * max|out|. Both packages quantize the activations per (row,
k-tile) and requantize the weights per (k-tile, column) with the same
divisions and roundings, and the int32 dots are exact; the only slack is
XLA:CPU's contraction of out += dot * (xs * s8) into a fused multiply-add.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.pallas.q8_matmul import (  # noqa: E402
    q8i8_matmul_stacked as jax_stacked,
    q8i8_matmul_tiled as jax_tiled,
    repack_tiles,
)
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402

D, LAYERS = 256, 3


def _inputs(seed, b, n, g):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(LAYERS, D, n)).astype(np.int8)
    ws = (0.02 / 127 * (0.5 + rng.random((LAYERS, D, n // g)))).astype(
        np.float32)
    qt, st = repack_tiles(np.ascontiguousarray(np.swapaxes(wq, -1, -2)),
                          np.ascontiguousarray(np.swapaxes(ws, -1, -2)), g)
    return x, wq, ws, qt, st


def _close(got, want):
    want = np.asarray(want)
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)), err


# (n, G): one 512-wide k-tile, two, six, the whole-axis fallback (no
# multiple of 8 * G up to 512 divides 768), the `tiny` preset's 128 at G = 32
# (whole axis), and a whole-axis tile wide enough that the plain version
# takes its dots in fp64 (1280 * 127 * 128 > 2^24)
SHAPES = [(512, 64), (1024, 64), (3072, 64), (768, 64), (128, 32),
          (1280, 64)]


@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("n,g", SHAPES)
def test_int8_plain_matches_jax(b, n, g):
    """Layer 2 of a 3-layer stack (stacked) and layer 0's tensor alone
    (tiled, the classifier's kernel)."""
    x, wq, ws, qt, st = _inputs(b * 100 + n + g, b, n, g)
    want = jax_stacked(jnp.asarray(x), jnp.asarray(qt), jnp.asarray(st),
                       jnp.int32(2), g, interpret=True)
    got = tq.q8i8_matmul_stacked(torch.from_numpy(x), torch.from_numpy(wq),
                                 torch.from_numpy(ws), 2, g)
    _close(got.numpy(), want)
    want = jax_tiled(jnp.asarray(x), jnp.asarray(qt[0]), jnp.asarray(st[0]),
                     g, interpret=True)
    got = tq.q8i8_matmul_tiled(torch.from_numpy(x), torch.from_numpy(wq[0]),
                               torch.from_numpy(ws[0]), g)
    _close(got.numpy(), want)


def test_int8_tile_is_the_tpu_kernels():
    """tk = _pick_tile(n, 8 * G, 512): 512 at every qwen3 width, the whole
    axis where no multiple of 8 * G up to 512 divides n."""
    assert [tq.int8_tile(n, 64) for n in (1024, 2048, 3072, 2560, 9728)] \
        == [512] * 5
    assert tq.int8_tile(768, 64) == 768
    assert tq.int8_tile(128, 32) == 128
    assert tq.int8_tile(256, 32) == 256


def test_int8_rows_and_leading_dims():
    """[B, T, n] activations flatten per row; a row's output does not
    depend on the other rows (its quantization is per row)."""
    n, g = 1024, 64
    x, wq, ws, _, _ = _inputs(5, 6, n, g)
    xt, wt, st = (torch.from_numpy(a) for a in (x, wq[1], ws[1]))
    full = tq.q8i8_matmul_tiled(xt.reshape(2, 3, n), wt, st, g)
    assert full.shape == (2, 3, D)
    for r in range(6):
        alone = tq.q8i8_matmul_tiled(xt[r:r + 1], wt, st, g)
        assert torch.equal(full.reshape(6, D)[r:r + 1], alone)


def test_int8_requantization_is_the_tpu_kernels():
    """The weight tile in the kernel's int8: s8 the tile's largest group
    scale, w8 = round_half_away(f32(wq) * (ws / s8)); with every group
    scale equal, w8 is wq itself and the product is the exact kernel's with
    one activation scale a k-tile."""
    n, g = 1024, 64
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (D, n)).astype(np.int8))
    ws = torch.full((D, n // g), 0.01, dtype=torch.float32)
    got = tq.q8i8_matmul_tiled(x, wq, ws, g)
    xq, xs = tq.quantize_act(x, 512)
    dots = [(xq[:, t * 512:(t + 1) * 512].double()
             @ wq[:, t * 512:(t + 1) * 512].double().T).float()
            for t in range(2)]
    want = dots[0] * (xs[:, :1] * 0.01) + dots[1] * (xs[:, 1:] * 0.01)
    assert torch.equal(got, want)
