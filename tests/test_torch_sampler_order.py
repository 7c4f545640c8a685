"""The sampler's fixed-order sums (csrc/sampler.cu's plain versions,
ops/cuda/sampler.py) on the CPU: a row's bits do not depend on its batch,
a prefix sum's first k entries do not depend on n, and sample_tokens
through the ordered route (the card's) meets the JAX package's sampler
under chip_smoke.check_sampler's criterion. The kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py -k
sampler_order)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.runtime import sampler as jsamp  # noqa: E402
from qwen3_tpu_torch.ops.cuda import sampler as cs  # noqa: E402
from qwen3_tpu_torch.runtime import sampler as tsamp  # noqa: E402

V_FULL = 151936


def _probs(rng, b, n):
    p = rng.random((b, n)).astype(np.float32) ** 4
    return torch.from_numpy(p / p.sum(axis=-1, keepdims=True))


@pytest.mark.parametrize("n", [512, V_FULL])
@pytest.mark.parametrize("batch", [4, 8, 64])
def test_row_bits_do_not_follow_the_batch(n, batch):
    """Each row of a batch has the bits it has alone, for both sums."""
    rng = np.random.default_rng(n + batch)
    x = _probs(rng, batch, n)
    sums, scans = cs.softmax_sum_ordered(x), cs.cumsum_ordered(x)
    for i in (0, batch // 2, batch - 1):
        row = x[i:i + 1].contiguous()
        assert torch.equal(cs.softmax_sum_ordered(row), sums[i:i + 1])
        assert torch.equal(cs.cumsum_ordered(row), scans[i:i + 1])
    assert torch.equal(cs.softmax_sum_ordered(x[:4].contiguous()), sums[:4])
    assert torch.equal(cs.cumsum_ordered(x[:4].contiguous()), scans[:4])


@pytest.mark.parametrize("n,k", [(512, 64), (V_FULL, 64), (V_FULL, 1),
                                 (V_FULL, cs.SCAN_TILE),
                                 (V_FULL, cs.SCAN_TILE + 1), (5000, 4097)])
def test_prefix_does_not_depend_on_n(n, k):
    """The full scan's first k sums equal the k-candidate scan's bit for
    bit, across tile edges; both within float32 rounding of the float64
    sum."""
    rng = np.random.default_rng(k)
    x = _probs(rng, 3, n)
    full = cs.cumsum_ordered(x)
    part = cs.cumsum_ordered(x[:, :k].contiguous())
    assert torch.equal(part, full[:, :k])
    want = np.cumsum(x.numpy().astype(np.float64), axis=-1)
    assert np.abs(full.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("n", [1, 3, 512, 4099, V_FULL])
def test_softmax_sum_ordered_is_the_sum(n):
    """The ordered sum within float32 rounding of the float64 sum, and
    equal to torch.sum where the order cannot matter (one value)."""
    rng = np.random.default_rng(n)
    e = torch.from_numpy(rng.random((5, n)).astype(np.float32))
    got = cs.softmax_sum_ordered(e)
    want = e.double().sum(-1)
    assert got.shape == (5,) and got.dtype == torch.float32
    assert ((got.double() - want).abs() <= 1e-6 * want).all()
    if n == 1:
        assert torch.equal(got, e[:, 0])


def test_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the wrappers raise (the sampler takes torch.sum and
    torch.cumsum there); a non-contiguous or non-fp32 tensor is refused
    before any launch."""
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cs.softmax_sum(x)
    with pytest.raises(ValueError, match="CUDA"):
        cs.prefix_sum(x)
    with pytest.raises(TypeError):
        cs.check(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        cs.check(torch.ones(8, 2).t())
    with pytest.raises(ValueError):
        cs.check(torch.ones(8))


@pytest.fixture
def ordered_route(monkeypatch):
    """sample_tokens as it runs on the card (the kernels' route, the top-k
    mass read from the ordered prefix), with the plain versions in the
    kernels' place: the card's bits on the CPU."""
    monkeypatch.setattr(tsamp, "_on_card", lambda x: True)
    monkeypatch.setattr(tsamp, "_cuda", types.SimpleNamespace(
        softmax_sum=cs.softmax_sum_ordered, prefix_sum=cs.cumsum_ordered))


@pytest.fixture(scope="module")
def jax_sample():
    return jax.jit(jsamp.sample_tokens, static_argnames=("greedy",
                                                         "top_k_hint"))


def _cases(rng, rows, vocab):
    z = rng.standard_normal((rows, vocab), dtype=np.float32)
    peaked = z.copy()
    for row in peaked:
        row[rng.choice(vocab, 16, replace=False)] += (
            15 + 2 * rng.random(16, dtype=np.float32))
    return (    # name, logits, top_p, top_k_hint, exact (no rows may differ)
        ("top-64 fast path", peaked, 0.9, 64, True),
        ("full scan", 2 * z, 0.9, 64, False),
        ("healed mass, top-64", 0.5 * z, 1e-6, 64, True),
        ("healed mass, full scan", 0.5 * z, 1e-6, 0, True))


@pytest.mark.parametrize("vocab", [512, V_FULL])
def test_ordered_route_meets_jax(ordered_route, jax_sample, vocab):
    """check_sampler's criterion against the JAX package's sample_tokens
    (t 0.8): the picks equal, save that in the full scan a tenth of the
    rows at most may pick another token, and only one whose float64
    cumulative interval lies within 2e-5 of the coin's point."""
    rows, temp = 32, 0.8
    rng = np.random.default_rng(vocab)
    coins = rng.random(rows, dtype=np.float32)
    calls = tsamp.CALLS["sampled"]
    for name, logits, top_p, hint, exact in _cases(rng, rows, vocab):
        want = np.asarray(jax_sample(jnp.asarray(logits), jnp.asarray(coins),
                                     temp, top_p, greedy=False,
                                     top_k_hint=hint))
        got = tsamp.sample_tokens(torch.from_numpy(logits),
                                  torch.from_numpy(coins), temp, top_p,
                                  top_k_hint=hint).numpy()
        differ = np.nonzero(got != want)[0]
        assert not (exact and len(differ)), (name, differ)
        assert len(differ) <= rows // 10, (name, differ)
        probs = torch.softmax(torch.from_numpy(logits).double() / temp, -1)
        sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        cum = sp.cumsum(-1)
        for i in differ:
            idx = int(torch.nonzero(cum[i] > top_p)[0, 0])
            r = float(coins[i]) * cum[i, idx].item()
            rank = int(torch.nonzero(order[i] == int(got[i]))[0, 0])
            lo = cum[i, rank - 1].item() if rank else 0.0
            assert max(lo - r, r - cum[i, rank].item()) <= 2e-5, (name, i)
    assert tsamp.CALLS["sampled"] == calls + 4


def test_ordered_route_rows_do_not_follow_the_batch(ordered_route):
    """sample_tokens through the ordered route: 8 rows sampled together
    pick what their first 4 pick alone (seeded as serve.py: t 0.8, top-p
    0.9, top-k hint 64), over flat and peaked draws."""
    rng = np.random.default_rng(3)
    for spread in (2.0, 6.0):
        lg = torch.from_numpy(
            spread * rng.standard_normal((8, V_FULL), dtype=np.float32))
        coin = torch.from_numpy(rng.random(8, dtype=np.float32))
        t8 = tsamp.sample_tokens(lg, coin, 0.8, 0.9, top_k_hint=64)
        t4 = tsamp.sample_tokens(lg[:4].contiguous(), coin[:4].contiguous(),
                                 0.8, 0.9, top_k_hint=64)
        assert torch.equal(t8[:4], t4)
