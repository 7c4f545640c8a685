"""The prologue-fused Q8_0 matmul of the PyTorch port (ops/cuda/q8_matmul.py
::q8_fused_matmul_plain, which the wrapper runs on the CPU) against the JAX
package's q8_matmul_fused (Pallas, interpret mode), with the tolerances of
tests/test_fused_prologue.py: rtol 1e-4 / atol 1e-6 for the exact (Q8_0 x
Q8_0) product, whose fp32 scale-and-sum XLA:CPU contracts into fused
multiply-adds; 2e-2 for the fast (bf16) one, whose TPU kernel takes one
full-K dot where the port sums each group in order. And the port's fused
function against its own unfused chain (rmsnorm / swiglu -> quantize_act or
round_bf16 -> the q8q8 or fast matmul), bit for bit: fuse on or off changes
launches, not numbers. The CUDA kernel against its plain version is in
test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.norms import rms_inv as jax_rms_inv  # noqa: E402
from qwen3_tpu.ops.pallas.q8_matmul import (  # noqa: E402
    q8_matmul_fused as jax_fused,
    repack_tiles,
)
from qwen3_tpu_torch.ops.activations import swiglu  # noqa: E402
from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402
from qwen3_tpu_torch.ops.norms import rms_inv, rmsnorm  # noqa: E402
from qwen3_tpu_torch.ops.q8 import quantize_act, round_bf16  # noqa: E402

G, N, D = 64, 1024, 768


def _weights(seed, n=N, g=G):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((D, n)).astype(np.float32) * 0.02
    s = np.abs(w).reshape(D, n // g, g).max(axis=-1) / 127.0 + 1e-6
    q = np.clip(np.round(w / np.repeat(s, g, axis=-1)), -127, 127)
    return q.astype(np.int8), s.astype(np.float32)


def _case(seed, b, prologue, n=N, g=G):
    rng = np.random.default_rng(seed)
    width = 2 * n if prologue == "swiglu" else n
    x = rng.standard_normal((b, width)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    wq, ws = _weights(seed + 1, n, g)
    return x, nw, wq, ws


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("prologue", ["norm", "swiglu", "none"])
@pytest.mark.parametrize("b,g", [(1, G), (8, G), (3, G), (1, 32), (3, 32),
                                 (1, 128), (3, 128)])
def test_fused_plain_matches_jax(b, g, prologue, exact):
    """b = 1 (the kernel's GEMV) and b = 3, 8 (its tile paths), G 32-128."""
    x, nw, wq, ws = _case(b + len(prologue) + g, b, prologue, g=g)
    qt, st = repack_tiles(np.ascontiguousarray(wq.T),
                          np.ascontiguousarray(ws.T), g)
    kw = {}
    if prologue == "norm":
        kw = dict(inv=jax_rms_inv(jnp.asarray(x)), nw=jnp.asarray(nw))
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(qt),
                                jnp.asarray(st), g, prologue=prologue,
                                exact=exact, interpret=True, **kw))
    xt = torch.from_numpy(x)
    inv = rms_inv(xt) if prologue == "norm" else None
    got = tq.q8_matmul_fused(xt, torch.from_numpy(wq), torch.from_numpy(ws),
                             g, inv, torch.from_numpy(nw), prologue=prologue,
                             exact=exact).numpy()
    tol = dict(rtol=1e-4, atol=1e-6) if exact else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("prologue", ["norm", "swiglu", "none"])
@pytest.mark.parametrize("n,g", [(1024, 64), (128, 32)])
def test_fused_equals_the_unfused_chain(n, g, prologue, exact):
    """Bit for bit, at b = 5 with [B, T, n] leading dims, against the
    port's unfused ops and matmuls (on the CPU, their plain versions)."""
    x, nw, wq, ws = _case(n + len(prologue), 6, prologue, n, g)
    xt = torch.from_numpy(x).reshape(2, 3, -1)
    nwt, wqt, wst = (torch.from_numpy(a) for a in (nw, wq, ws))
    if prologue == "norm":
        h = rmsnorm(xt, nwt)
    elif prologue == "swiglu":
        h = swiglu(xt[..., :n], xt[..., n:])
    else:
        h = xt
    if exact:
        want = tq.q8_q8_matmul_tiled(*quantize_act(h, g), wqt, wst, g)
    else:
        want = tq.q8_matmul_tiled_fast(round_bf16(h), wqt, wst, g)
    before = dict(tq.LAUNCHES)
    got = tq.q8_matmul_fused(xt, wqt, wst, g, rms_inv(xt), nwt,
                             prologue=prologue, exact=exact)
    assert got.shape == (2, 3, D)
    assert torch.equal(got, want)
    assert tq.LAUNCHES == before      # the CPU runs the plain version


def test_rms_inv_factors_rmsnorm_bitwise():
    """nw * (x * rms_inv(x)) is rmsnorm(x, nw) bit for bit, and rms_inv is
    the JAX package's within an ulp."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 1024)).astype(np.float32) * 3
    nw = (1 + 0.1 * rng.standard_normal(1024)).astype(np.float32)
    xt, nwt = torch.from_numpy(x), torch.from_numpy(nw)
    inv = rms_inv(xt)
    assert inv.shape == (4, 5, 1)
    assert torch.equal(nwt * (xt * inv), rmsnorm(xt, nwt))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jax_rms_inv(x)),
                               rtol=2e-7, atol=0)


def test_fused_refuses_a_bad_prologue():
    x, nw, wq, ws = (torch.from_numpy(a) for a in _case(0, 1, "norm"))
    with pytest.raises(ValueError, match="prologue"):
        tq.q8_matmul_fused(x, wq, ws, G, prologue="gelu")
    with pytest.raises(ValueError, match="inv and nw"):
        tq.q8_matmul_fused(x, wq, ws, G, prologue="norm")
