"""The port's untiled matmuls on contraction-leading weights
(ops/cuda/q8_matmul.py::q8_q8_matmul_pallas and ::q8_matmul_pallas, whose
plain versions run on the CPU) against the JAX package's Pallas kernels of
the same names in interpret mode, on the same numpy inputs.

Tolerance 1e-5 * max|out| for both. q8_q8_matmul_pallas takes exact int32
group dots and the same fp32 products and sums in group and k-tile order in
both packages, but XLA:CPU contracts acc + dot * (xs * ws) into a fused
multiply-add, so about half the outputs differ in the last bit.
q8_matmul_pallas's dots are fp32 sums whose order is XLA's dot in the JAX
kernel and torch.matmul's in the port (with bf16 the products of two bf16
values are exact in fp32, so only that order differs). The CUDA kernels against their plain versions are in
test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.pallas.q8_matmul import (  # noqa: E402
    q8_matmul_pallas as jax_q8,
    q8_q8_matmul_pallas as jax_q8q8,
)
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weights(rng, n, d, g):
    wq = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    ws = (0.01 * (0.5 + rng.random((n // g, d)))).astype(np.float32)
    return wq, ws


def _close(got, want):
    want = np.asarray(want)
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)), err


# (lead, n, d, G): the JAX tests' shapes (tests/test_pallas_mode.py), two
# 512-wide k-tiles, and n = 768, where no multiple of 8 G up to 512 divides
# n and the k-tile is the whole axis
Q8Q8_CASES = [((2,), 256, 128, 32), ((1,), 768, 256, 64), ((4,), 1024, 256, 64),
              ((2, 3), 512, 128, 64)]


@pytest.mark.parametrize("lead,n,d,g", Q8Q8_CASES)
def test_q8q8_untiled_plain_matches_jax(lead, n, d, g):
    rng = np.random.default_rng(n + d)
    wq, ws = _weights(rng, n, d, g)
    xq = rng.integers(-127, 128, size=lead + (n,)).astype(np.int8)
    xs = rng.random(lead + (n // g,)).astype(np.float32)
    want = jax_q8q8(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq),
                    jnp.asarray(ws), g, interpret=True)
    got = tq.q8_q8_matmul_pallas(*(torch.from_numpy(a)
                                   for a in (xq, xs, wq, ws)), g)
    assert got.shape == lead + (d,)
    _close(got.numpy(), want)


@pytest.mark.parametrize("postscale", [False, True])
@pytest.mark.parametrize("cdt", sorted(DTYPES))
@pytest.mark.parametrize("lead,n,d,g", [((4,), 128, 256, 32),
                                        ((2, 3), 64, 128, 32),
                                        ((3,), 1024, 128, 64)])
def test_q8_untiled_plain_matches_jax(lead, n, d, g, cdt, postscale):
    """x in f32 (and, at the first shape, bf16) through each compute dtype,
    the scales before or after the dot; 2-D and 3-D batches."""
    jdt, tdt = DTYPES[cdt]
    rng = np.random.default_rng(n * 7 + d)
    wq, ws = _weights(rng, n, d, g)
    x = (rng.standard_normal(lead + (n,)) * 0.1).astype(np.float32)
    x_dtypes = [jnp.float32] + ([jnp.bfloat16] if n == 128 else [])
    for xdt in x_dtypes:
        jx = jnp.asarray(x, xdt)
        want = jax_q8(jx, jnp.asarray(wq), jnp.asarray(ws), g,
                      compute_dtype=jdt, postscale=postscale, interpret=True)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
        if xdt == jnp.bfloat16:
            tx = tx.to(torch.bfloat16)
        got = tq.q8_matmul_pallas(tx, torch.from_numpy(wq),
                                  torch.from_numpy(ws), g, compute_dtype=tdt,
                                  postscale=postscale)
        assert got.shape == lead + (d,) and got.dtype == torch.float32
        _close(got.numpy(), want)


def test_untiled_plain_refuses():
    wq = torch.zeros(64, 32, dtype=torch.int8)
    ws = torch.zeros(2, 32)
    with pytest.raises(ValueError):
        tq.q8_matmul_pallas(torch.zeros(1, 64), wq, ws, 32,
                            compute_dtype=torch.float16)
