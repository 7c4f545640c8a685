"""The Q8_0 matmuls of the PyTorch port against the JAX package's Pallas
kernels (q8_q8_matmul_stacked / q8_q8_matmul_tiled, and the pallas-fast
q8_matmul_stacked_fast / q8_matmul_tiled_fast, in interpret mode), on
weights repacked by the JAX package's repack_tiles and un-tiled by the port.
The CUDA kernels against their plain versions are in test_torch_cuda.py.

Tolerance against JAX. The group dots are exact integers in both packages,
and both sum the fp32 terms dot * (xs * ws) in the same order. They still
differ in the last bits, because XLA:CPU, which runs the interpret-mode
kernel, contracts the sum into fused multiply-adds: it computes
fma(dot0, p0, dot1 * p1), then fma(dot_i, p_i, acc). The port rounds every
product and every sum (the CUDA kernel with __fmul_rn/__fadd_rn), so its
kernel and plain version agree bit for bit with each other, and each step
differs from XLA:CPU's by at most one rounding of a partial sum. The bound
below is two such roundings per group term, 2 * ng * 2^-24 times the sum of
the terms' magnitudes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.pallas.q8_matmul import (  # noqa: E402
    q8_matmul_stacked_fast as jax_stacked_fast,
    q8_matmul_tiled_fast as jax_tiled_fast,
    q8_q8_matmul_stacked as jax_stacked,
    q8_q8_matmul_tiled as jax_tiled,
    repack_tiles,
)
from qwen3_tpu.ops.q8 import quantize_act as jax_quantize_act  # noqa: E402
from qwen3_tpu_torch.models.qwen3 import untile  # noqa: E402
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402


def _inputs(seed, b, n, d, g, layers=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)).astype(np.float32)
    lead = () if layers is None else (layers,)
    wq = rng.integers(-127, 128, size=lead + (d, n)).astype(np.int8)
    ws = (0.02 / 127 * (0.5 + rng.random(lead + (d, n // g)))).astype(
        np.float32)
    xq, xs = jax_quantize_act(jnp.asarray(x), g)
    return np.array(xq), np.array(xs), wq, ws


def _assert_fp32_sum_close(got, want, xq, xs, wq, ws, g):
    """|got - want| <= 2 * ng * 2^-24 * sum_g |dot_g * xs_g * ws_g|."""
    mag = tq.q8q8_matmul_plain(torch.from_numpy(np.abs(xq)),
                               torch.from_numpy(xs),
                               torch.from_numpy(np.abs(wq)),
                               torch.from_numpy(ws), g).numpy()
    bound = 2 * (xq.shape[-1] // g) * 2.0 ** -24 * mag
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= bound), float(np.max(err / np.maximum(bound, 1e-30)))


def _jax_packed(wq, ws, g):
    # the JAX package's pallas layout: [.., n, d] transposed, then tiled
    qt, st = repack_tiles(np.ascontiguousarray(np.swapaxes(wq, -1, -2)),
                          np.ascontiguousarray(np.swapaxes(ws, -1, -2)), g)
    return qt, st


# (n, G): one k-tile (128/32 -> tk = n), two tiles (1024/32 and 1024/64,
# tk = 512), three tiles (1536/64)
SHAPES = [(128, 32), (1024, 32), (1024, 64), (1536, 64)]


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("n,g", SHAPES)
def test_tiled_plain_matches_jax(b, n, g):
    """Classifier kernel. d = 1152 has no tile >= 512 dividing it, so
    repack_tiles zero-pads it to 2048 columns; the port keeps 1152."""
    d = 1152
    xq, xs, wq, ws = _inputs(b * 1000 + n + g, b, n, d, g)
    qt, st = _jax_packed(wq, ws, g)
    assert qt.shape[0] * qt.shape[2] == 2048  # padded on the JAX side
    want = np.asarray(jax_tiled(jnp.asarray(xq), jnp.asarray(xs),
                                jnp.asarray(qt), jnp.asarray(st), g,
                                interpret=True))[:, :d]
    w_q, w_s = untile(qt, d), untile(st, d)
    np.testing.assert_array_equal(w_q, wq)
    got = tq.q8_q8_matmul_tiled(torch.from_numpy(xq), torch.from_numpy(xs),
                                torch.from_numpy(w_q), torch.from_numpy(w_s),
                                g).numpy()
    _assert_fp32_sum_close(got, want, xq, xs, wq, ws, g)


@pytest.mark.parametrize("b", [1, 7, 8, 16, 17, 64, 65])
@pytest.mark.parametrize("n,g", SHAPES)
def test_stacked_plain_matches_jax(b, n, g):
    """Layer kernel on a 3-layer stack, layers 0 and 2. The CUDA tile path
    (b > 1) runs 16-row tiles up to b = 16, 32-row tiles up to 64 and
    64-row tiles past it: b = 16/17 and 64/65 sit on either side of its
    shape boundaries, b = 8 is serving's batch in mode pallas."""
    d = 384
    xq, xs, wq, ws = _inputs(b * 7 + n + g, b, n, d, g, layers=3)
    qt, st = _jax_packed(wq, ws, g)
    w_q = torch.from_numpy(untile(qt, d))
    w_s = torch.from_numpy(untile(st, d))
    for layer in (0, 2):
        want = np.asarray(jax_stacked(jnp.asarray(xq), jnp.asarray(xs),
                                      jnp.asarray(qt), jnp.asarray(st),
                                      jnp.int32(layer), g, interpret=True))
        got = tq.q8_q8_matmul_stacked(torch.from_numpy(xq),
                                      torch.from_numpy(xs), w_q, w_s, layer,
                                      g).numpy()
        _assert_fp32_sum_close(got, want, xq, xs, wq[layer], ws[layer], g)


def test_plain_matches_xla_fma_order_bitwise():
    """Pins the tolerance's reason: written in XLA:CPU's contracted order
    (fmas emulated in float64, exact here: an integer below 2^24 times an
    fp32 value needs 48 bits), the plain version's group terms reproduce
    the JAX kernel bit for bit."""
    b, n, d, g = 3, 128, 1152, 32
    xq, xs, wq, ws = _inputs(11, b, n, d, g)
    qt, st = _jax_packed(wq, ws, g)
    want = np.asarray(jax_tiled(jnp.asarray(xq), jnp.asarray(xs),
                                jnp.asarray(qt), jnp.asarray(st), g,
                                interpret=True))[:, :d]
    dots = np.einsum("bgk,dgk->gbd",
                     xq.reshape(b, n // g, g).astype(np.float64),
                     wq.reshape(d, n // g, g).astype(np.float64))
    p = (xs.T[:, :, None] * ws.T[:, None, :]).astype(np.float32)   # xs * ws
    acc = np.float32(dots[1] * p[1])
    acc = np.float32(dots[0] * p[0] + acc)
    for i in range(2, n // g):
        acc = np.float32(dots[i] * p[i] + acc)
    np.testing.assert_array_equal(acc, want)


def test_plain_group_dots_are_exact_integers():
    """The plain version's fp32 group dots equal int64 dots at the extreme
    |dot| = 64 * 127 * 127 (no int8 wrap, no fp32 rounding)."""
    g, n, d = 64, 512, 3
    xq = torch.full((1, n), -127, dtype=torch.int8)
    xs = torch.ones(1, n // g)
    wq = torch.full((d, n), -127, dtype=torch.int8)
    ws = torch.ones(d, n // g)
    out = tq.q8q8_matmul_plain(xq, xs, wq, ws, g)
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.full((1, d), float(n * 127 * 127)))


def test_groups_per_tile_matches_jax_pick_tile():
    from qwen3_tpu.ops.pallas.q8_matmul import _pick_tile

    for n, g in [(128, 32), (256, 32), (512, 32), (1024, 64), (3072, 64),
                 (1536, 64), (9728, 64), (640, 64)]:
        assert tq.groups_per_tile(n, g) * g == _pick_tile(n, 8 * g, 512)


def test_cpu_tensors_take_plain_version_and_count_nothing():
    xq, xs, wq, ws = _inputs(3, 2, 128, 64, 32)
    tq.reset_launches()
    out = tq.q8_q8_matmul_tiled(torch.from_numpy(xq), torch.from_numpy(xs),
                                torch.from_numpy(wq), torch.from_numpy(ws),
                                32)
    assert out.shape == (2, 64)
    out = tq.q8_matmul_tiled_fast(torch.from_numpy(xq).float(),
                                  torch.from_numpy(wq), torch.from_numpy(ws),
                                  32)
    assert out.shape == (2, 64)
    x = torch.from_numpy(xq).float()
    assert tq.q8i8_matmul_tiled(x, torch.from_numpy(wq), torch.from_numpy(ws),
                                32).shape == (2, 64)
    assert tq.q8_matmul_fused(x, torch.from_numpy(wq), torch.from_numpy(ws),
                              32, exact=True).shape == (2, 64)
    wt = torch.from_numpy(wq).T.contiguous()         # the untiled [n, d]
    st = torch.from_numpy(ws).T.contiguous()
    assert tq.q8_q8_matmul_pallas(torch.from_numpy(xq), torch.from_numpy(xs),
                                  wt, st, 32).shape == (2, 64)
    assert tq.q8_matmul_pallas(x, wt, st, 32).shape == (2, 64)
    assert tq.LAUNCHES == {"stacked": 0, "tiled": 0, "stacked_fast": 0,
                           "tiled_fast": 0, "stacked_int8": 0,
                           "tiled_int8": 0, "fused": 0, "q8q8_pallas": 0,
                           "pallas": 0}


def test_non_cpu_tensor_never_takes_plain_version():
    """A tensor that is not on the CPU goes to the kernel's launcher, which
    refuses what the kernel does not take; there is no fallback."""
    xq = torch.empty(1, 128, dtype=torch.int8, device="meta")
    xs = torch.empty(1, 4, device="meta")
    wq = torch.empty(64, 128, dtype=torch.int8, device="meta")
    ws = torch.empty(64, 4, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        tq.q8_q8_matmul_tiled(xq, xs, wq, ws, 32)
    with pytest.raises(ValueError, match="power of two"):
        tq.q8_q8_matmul_tiled(xq, xs, wq, ws, 48)
    x = torch.empty(1, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        tq.q8_matmul_tiled_fast(x, wq, ws, 32)
    with pytest.raises(ValueError, match="power of two"):
        tq.q8_matmul_stacked_fast(x, wq[None], ws[None], 0, 48)
    xf = torch.empty(1, 128, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        tq.q8i8_matmul_tiled(xf, wq, ws, 32)
    with pytest.raises(ValueError, match="must be on"):
        tq.q8i8_matmul_stacked(xf, wq[None], ws[None], 0, 32)
    with pytest.raises(ValueError, match="must be on"):
        tq.q8_matmul_fused(xf, wq, ws, 32, exact=True)
    assert all(v == 0 for v in tq.LAUNCHES.values())


# -- pallas-fast --------------------------------------------------------------
#
# Tolerance against JAX: 1e-5 * max(1, max|want|). Both packages take the
# same bf16 operands (the activation rounded to nearest even, the weight
# bf16(f32(wq) * ws)), and every product of two bf16 values is exact in
# fp32, so only the order of the fp32 sums differs: the Pallas kernel's
# full-K dot per 512-wide k-tile (XLA:CPU's order in interpret mode) against
# the port's per-group sequential sums added group by group. Measured: at
# most 4.2e-7 over the shapes below.

def _fast_inputs(seed, b, n, d, g, layers=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)).astype(np.float32)
    lead = () if layers is None else (layers,)
    wq = rng.integers(-127, 128, size=lead + (d, n)).astype(np.int8)
    ws = (0.02 / 127 * (0.5 + rng.random(lead + (d, n // g)))).astype(
        np.float32)
    return x, wq, ws


def _fast_close(got, want):
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(want)))), err


@pytest.mark.parametrize("b", [1, 5, 64])
@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("n", [256, 3072])
def test_fast_stacked_and_tiled_plain_match_jax(n, d, b):
    """Layer kernel (layer 1 of a 2-layer stack) and classifier kernel
    (layer 0's weights alone)."""
    g = 64
    x, wq, ws = _fast_inputs(n + d + b, b, n, d, g, layers=2)
    qt, st = _jax_packed(wq, ws, g)
    w_q = torch.from_numpy(untile(qt, d))
    w_s = torch.from_numpy(untile(st, d))
    want = np.asarray(jax_stacked_fast(jnp.asarray(x), jnp.asarray(qt),
                                       jnp.asarray(st), jnp.int32(1), g,
                                       interpret=True))[:, :d]
    got = tq.q8_matmul_stacked_fast(torch.from_numpy(x), w_q, w_s, 1,
                                    g).numpy()
    _fast_close(got, want)
    qt0, st0 = _jax_packed(wq[0], ws[0], g)
    want = np.asarray(jax_tiled_fast(jnp.asarray(x), jnp.asarray(qt0),
                                     jnp.asarray(st0), g,
                                     interpret=True))[:, :d]
    got = tq.q8_matmul_tiled_fast(torch.from_numpy(x), w_q[0], w_s[0],
                                  g).numpy()
    _fast_close(got, want)


def test_fast_plain_rows_do_not_depend_on_the_batch():
    """Row r of a b = 64 call equals, bit for bit, the same row run alone
    (the serving engine's contract that a stream's tokens do not depend on
    its batch-mates; the CUDA kernel is held to it in test_torch_cuda.py)."""
    g, n, d = 64, 1024, 320
    x, wq, ws = _fast_inputs(9, 64, n, d, g)
    xt, wq, ws = (torch.from_numpy(a) for a in (x, wq, ws))
    full = tq.q8_fast_matmul_plain(xt, wq, ws, g)
    for r in (0, 17, 63):
        assert torch.equal(full[r:r + 1],
                           tq.q8_fast_matmul_plain(xt[r:r + 1], wq, ws, g))


def test_fast_plain_order_is_the_kernels():
    """Pins the plain version's order against an independent float64
    emulation: each step rounded to fp32, per group the products summed in
    k order, then the groups in order (an fp32 sum whose operands are
    products of bf16 values rounds once, as the kernel's fmaf does)."""
    g, n, d, b = 32, 128, 5, 3
    x, wq, ws = _fast_inputs(4, b, n, d, g)
    xt = torch.from_numpy(x)
    got = tq.q8_fast_matmul_plain(xt, torch.from_numpy(wq),
                                  torch.from_numpy(ws), g).numpy()
    xb = xt.to(torch.bfloat16).float().numpy().astype(np.float64)
    wf = (torch.from_numpy(wq).float().reshape(d, n // g, g)
          * torch.from_numpy(ws)[..., None]).to(torch.bfloat16).float()
    wb = wf.reshape(d, n).numpy().astype(np.float64)
    want = np.zeros((b, d), np.float32)
    for r in range(b):
        for c in range(d):
            o = np.float32(0)
            for gi in range(n // g):
                s = np.float32(0)
                for k in range(gi * g, (gi + 1) * g):
                    s = np.float32(np.float64(s) + xb[r, k] * wb[c, k])
                o = np.float32(np.float64(o) + np.float64(s))
            want[r, c] = o
    np.testing.assert_array_equal(got, want)
