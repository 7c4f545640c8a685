"""The norms' dispatch and the fixed-order norm kernel's plain versions on the
CPU (qwen3_tpu_torch/ops/norms.py, ops/cuda/norms.py): what the CPU path and
the kernel's wrapper refuse, that a CPU tensor runs today's torch.mean chain
bit for bit (and within 1e-6 of the JAX package's norms on the same numpy
inputs), how the kernel walks a row's layout, and that rms_inv_ordered, the
plain version in the kernel's sum order, holds NORM_RTOL of the torch.mean
chain. The kernel itself is held to rms_inv_ordered bit for bit on the card
(test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops import norms as jnorms  # noqa: E402
from qwen3_tpu_torch.ops import norms as tnorms  # noqa: E402
from qwen3_tpu_torch.ops.cuda import norms as cn  # noqa: E402

# the QK-norm's head_dim and the model dims of qwen3-0.6b, 4b and 8b, and a
# ragged width that takes the kernel's scalar path
WIDTHS = (128, 1024, 2560, 4096, 130)


def _x(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _today(x, w=None, eps=1e-6):
    """The norms as the port wrote them before the kernel: the CPU plain
    code."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    return inv if w is None else (w.float() * (xf * inv)).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", WIDTHS)
def test_cpu_dispatch_is_todays_plain_code(n, dtype):
    """On a CPU tensor rmsnorm and rms_inv are the torch.mean chain, bit for
    bit, and launch nothing."""
    x = torch.from_numpy(_x(n, (3, 5, n))).to(dtype)
    w = torch.from_numpy(1 + 0.1 * _x(n + 1, (n,), 1.0))
    cn.reset_launches()
    assert torch.equal(tnorms.rmsnorm(x, w), _today(x, w))
    assert torch.equal(tnorms.rms_inv(x), _today(x))
    assert torch.equal(tnorms.rmsnorm(x, w), tnorms.rmsnorm_plain(x, w))
    assert torch.equal(tnorms.rms_inv(x), tnorms.rms_inv_plain(x))
    assert not any(cn.LAUNCHES.values()), cn.LAUNCHES


@pytest.mark.parametrize("n", WIDTHS)
def test_cpu_norms_match_jax(n):
    """The CPU dispatch against qwen3_tpu/ops/norms.py on the same numpy
    inputs: within 1e-6 (XLA:CPU's rsqrt and reduction order may differ by
    an ulp)."""
    x = _x(2 * n, (4, 7, n))
    w = (1 + 0.1 * _x(2 * n + 1, (n,), 1.0)).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tnorms.rms_inv(torch.from_numpy(x)).numpy(),
        np.asarray(jnorms.rms_inv(jnp.asarray(x))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", WIDTHS)
def test_ordered_plain_holds_the_torch_mean_chain(n, dtype):
    """rms_inv_ordered (the kernel's order) within NORM_RTOL of the
    torch.mean chain, on rows of very different scales; and the norm built
    on it, w * (x * inv), within the same of rmsnorm in f32."""
    rng = np.random.default_rng(n)
    x = _x(3 * n, (64, n)) * np.exp(rng.uniform(-8, 8, (64, 1))).astype(
        np.float32)
    xt = torch.from_numpy(x).to(dtype)
    got, want = cn.rms_inv_ordered(xt), tnorms.rms_inv_plain(xt)
    assert got.shape == want.shape == (64, 1)
    rel = ((got - want).abs() / want).max().item()
    assert rel <= cn.NORM_RTOL, rel
    w = torch.from_numpy(1 + 0.1 * _x(n, (n,), 1.0))
    xf = xt.float()
    np.testing.assert_allclose((w * (xf * got)).numpy(),
                               tnorms.rmsnorm_plain(xf, w).numpy(),
                               rtol=2 * cn.NORM_RTOL, atol=1e-30)


def test_ordered_plain_is_a_per_row_function():
    """rms_inv_ordered of a row does not depend on the rows beside it or on
    their number (the kernel's property, here in plain ops)."""
    x = torch.from_numpy(_x(9, (512, 2560)))
    wide = cn.rms_inv_ordered(x)
    for b in (1, 8, 511):
        assert torch.equal(cn.rms_inv_ordered(x[:b]), wide[:b])
    assert torch.equal(cn.rms_inv_ordered(x[7]), wide[7])


@pytest.mark.parametrize("n,threads", [(1, 32), (128, 32), (1024, 32),
                                       (1025, 128), (2560, 128),
                                       (4096, 128)])
def test_row_threads_by_width(n, threads):
    """One warp a row up to 1024, 128 threads above: a function of n."""
    assert cn.row_threads(n) == threads


def test_rows_layout_of_views():
    """The kernel's two-level row walk: a contiguous tensor is one level; the
    q and k heads sliced from a [B, T, N] qkv output are (B T rows of N) x
    (H heads of D); a single row; size-1 dimensions drop out."""
    B, T, H, KV, D = 2, 3, 4, 2, 8
    N = (H + 2 * KV) * D
    qkv = torch.zeros(B, T, N)
    assert cn.rows_layout(torch.zeros(5, 7, 16)) == (1, 0, 35, 16)
    q = qkv[..., :H * D].reshape(B, T, H, D)
    k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D)
    assert cn.rows_layout(q) == (B * T, N, H, D)
    assert cn.rows_layout(k) == (B * T, N, KV, D)
    assert cn.rows_layout(torch.zeros(16)) == (1, 0, 1, 0)
    assert cn.rows_layout(torch.zeros(1, 3, 1, 16)) == (1, 0, 3, 16)
    # the walk reaches every row's first element
    r0, s0, r1, s1 = cn.rows_layout(k)
    base = k.storage_offset()
    firsts = [base + (r // r1) * s0 + (r % r1) * s1 for r in range(r0 * r1)]
    want = [k[b, t, h].storage_offset() for b in range(B) for t in range(T)
            for h in range(KV)]
    assert firsts == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norms_on_strided_views_equal_contiguous_rows(dtype):
    """A q/k view normalizes as its contiguous copy does (CPU plain code)."""
    B, T, H, D = 2, 3, 4, 32
    qkv = torch.from_numpy(_x(5, (B, T, 3 * H * D))).to(dtype)
    q = qkv[..., H * D:2 * H * D].reshape(B, T, H, D)
    w = torch.from_numpy(1 + 0.1 * _x(6, (D,), 1.0))
    assert torch.equal(tnorms.rmsnorm(q, w), tnorms.rmsnorm(q.contiguous(), w))
    assert torch.equal(tnorms.rms_inv(q), tnorms.rms_inv(q.contiguous()))
    assert torch.equal(cn.rms_inv_ordered(q),
                       cn.rms_inv_ordered(q.contiguous()))


def test_norm_refuses_dtypes():
    """x other than f32/bf16 and w other than f32, on the CPU path and in
    the kernel's check; the kernel's check also refuses w of another width
    and an empty row."""
    x = torch.zeros(2, 16)
    w = torch.ones(16)
    for bad in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="x must be"):
            tnorms.rmsnorm(x.to(bad), w)
        with pytest.raises(TypeError, match="x must be"):
            tnorms.rms_inv(x.to(bad))
        with pytest.raises(TypeError, match="x must be"):
            cn.check(x.to(bad), None)
    for bad in (torch.bfloat16, torch.float64):
        with pytest.raises(TypeError, match="w must be"):
            tnorms.rmsnorm(x, w.to(bad))
        with pytest.raises(TypeError, match="w must be"):
            cn.check(x, w.to(bad))
    with pytest.raises(ValueError, match="does not match"):
        cn.check(x, torch.ones(15))
    with pytest.raises(ValueError, match="non-empty"):
        cn.check(torch.zeros(2, 0), None)


def test_norm_refuses_devices():
    """The kernel's entry refuses a CPU tensor, and its check w on another
    device than x."""
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cn.rms_inv_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cn.rmsnorm_cuda(x, torch.ones(16))
    with pytest.raises(ValueError, match="w must be on"):
        cn.check(x, torch.ones(16, device="meta"))


def test_norm_refuses_layouts():
    """The kernel's check refuses a last dimension that is not contiguous
    and leading dimensions that do not collapse into two strided levels;
    the CPU path takes both, within 1e-6 of their contiguous copies."""
    x = torch.from_numpy(_x(3, (4, 6, 8, 16)))
    w = torch.from_numpy(1 + 0.1 * _x(4, (16,), 1.0))
    col = torch.from_numpy(_x(5, (16, 4))).T
    three = x[::2, :, :4]
    with pytest.raises(ValueError, match="contiguous"):
        cn.check(col, None)
    with pytest.raises(ValueError, match="two strided levels"):
        cn.check(three, None)
    with pytest.raises(ValueError, match="two strided levels"):
        cn.check(three, w)
    # two levels are taken
    assert cn.check(x[:, :, :4], None) == (24, 128, 4, 16)
    # (torch.mean on the CPU may sum a strided row in another order)
    np.testing.assert_allclose(tnorms.rms_inv(col).numpy(),
                               tnorms.rms_inv(col.contiguous()).numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tnorms.rmsnorm(three, w).numpy(),
                               tnorms.rmsnorm(three.contiguous(), w).numpy(),
                               rtol=1e-6, atol=0)
