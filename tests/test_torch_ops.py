"""The PyTorch port's eager ops against the JAX package's, on the same numpy
inputs: quantizers bit for bit (rounding ties included), the fp32 ops to
rtol 1e-6 (rsqrt, exp, sigmoid and reduction order may differ by an ulp
between XLA:CPU and PyTorch's CPU kernels)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops import activations as jact  # noqa: E402
from qwen3_tpu.ops import attention as jatt  # noqa: E402
from qwen3_tpu.ops import norms as jnorms  # noqa: E402
from qwen3_tpu.ops import q8 as jq8  # noqa: E402
from qwen3_tpu.ops import rope as jrope  # noqa: E402
from qwen3_tpu.runtime import kvcache as jkv  # noqa: E402
from qwen3_tpu_torch.ops import activations as tact  # noqa: E402
from qwen3_tpu_torch.ops import attention as tatt  # noqa: E402
from qwen3_tpu_torch.ops import norms as tnorms  # noqa: E402
from qwen3_tpu_torch.ops import q8 as tq8  # noqa: E402
from qwen3_tpu_torch.ops import rope as trope  # noqa: E402
from qwen3_tpu_torch.runtime import kvcache as tkv  # noqa: E402

RTOL = 1e-6


def _ties(scale_max: float, values) -> np.ndarray:
    """A group whose absmax is `scale_max` (scale exactly 1.0 at 127) and
    whose other entries sit exactly on .5 ties, where half-away and
    half-even rounding differ."""
    return np.array([scale_max] + list(values), dtype=np.float32)


def test_quantize_act_bitwise_with_ties():
    rng = np.random.default_rng(0)
    ties = _ties(127.0, [0.5, -0.5, 1.5, -2.5, 2.5, 126.5, -126.5])
    x = rng.standard_normal((5, 64)).astype(np.float32) * 3
    x[0, :8] = ties
    x[1] = 0.0                                    # zero group: 1e-6 guard
    jq, js = jq8.quantize_act(jnp.asarray(x), 32)
    tq, ts = tq8.quantize_act(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # half away from zero, as C roundf
    assert tq.numpy()[0, :8].tolist() == [127, 1, -1, 2, -3, 3, 127, -127]


def test_dequantize_bitwise():
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, size=(3, 128)).astype(np.int8)
    s = rng.random((3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tq8.dequantize(torch.from_numpy(q), torch.from_numpy(s), 32).numpy(),
        np.asarray(jq8.dequantize(jnp.asarray(q), jnp.asarray(s), 32)))


def test_kv_quantize_heads_bitwise_with_ties():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    x[0, 0, 0, :8] = _ties(127.0, [0.5, -0.5, 1.5, -2.5, 2.5, 3.5, -4.5])
    x[1, 2, 3] = 0.0
    jq, js = jkv.quantize_heads(jnp.asarray(x))
    tq, ts = tkv.quantize_heads(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # half to even, as jnp.round
    assert tq.numpy()[0, 0, 0, :8].tolist() == [127, 0, 0, 2, -2, 2, 4, -4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kv_cache_layout_and_encode(dtype):
    from qwen3_tpu.config import PRESETS

    cfg = PRESETS["tiny"]
    jk, _ = jkv.init_kv_cache(cfg, 2, 16, jnp.dtype(dtype))
    tk, _ = tkv.init_kv_cache(cfg, 2, 16, dtype, "cpu")
    jv, js = jkv.split(jk)
    tv, ts = tkv.split(tk)
    assert tuple(tv.shape) == jv.shape and str(tv.dtype).endswith(dtype)
    assert (ts is None) == (js is None)
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = np.random.default_rng(3).standard_normal((2, 1, 2, 32)).astype(
        np.float32)
    je, jes = jkv.encode_block(jv, jnp.asarray(x))
    te, tes = tkv.encode_block(tv, torch.from_numpy(x))
    np.testing.assert_array_equal(te.float().numpy(),
                                  np.asarray(je).astype(np.float32))
    assert (tes is None) == (jes is None)
    assert tkv.pad_rows(129) == jkv.pad_rows(129) == 256


def test_rmsnorm_close():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 7, 128)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=RTOL, atol=0)


def test_swiglu_close():
    rng = np.random.default_rng(5)
    g, u = rng.standard_normal((2, 3, 256)).astype(np.float32) * 4
    np.testing.assert_allclose(
        tact.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
        np.asarray(jact.swiglu(jnp.asarray(g), jnp.asarray(u))),
        rtol=RTOL, atol=1e-30)


def test_rope_tables_bitwise_and_rotation_close():
    jc, js = jrope.rope_tables(128, 4096)
    tc, ts = trope.rope_tables(128, 4096, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = np.random.default_rng(6).standard_normal((5, 8, 128)).astype(
        np.float32)
    pos = np.array([0, 1, 17, 1000, 4095])
    c, s = np.asarray(jc)[pos][:, None], np.asarray(js)[pos][:, None]
    np.testing.assert_allclose(
        trope.apply_rope(torch.from_numpy(x), torch.from_numpy(c),
                         torch.from_numpy(s)).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(c),
                                    jnp.asarray(s))),
        rtol=RTOL, atol=1e-6)


def _cache(rng, b, s, kv, d, int8):
    x = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    if not int8:
        return x, None
    q, sc = jkv.quantize_heads(jnp.asarray(x))
    return np.array(q), np.array(sc)


@pytest.mark.parametrize("int8", [False, True])
def test_gqa_attention_prefill_close(int8):
    """T=5 queries at positions 3..7 over a 300-row cache (the JAX package
    reads a 512-row bucket, the port the 8 live rows): masked rows give
    exact zeros either way."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k, ks = _cache(rng, 2, 300, 2, 32, int8)
    v, vs = _cache(rng, 2, 300, 2, 32, int8)
    pos = np.arange(3, 8, dtype=np.int32)
    opt = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(jatt.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        opt(ks), opt(vs)))
    topt = (lambda a: None if a is None else torch.from_numpy(a))
    got = tatt.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(pos),
                             topt(ks), topt(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_gqa_attention_per_slot_close(int8):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 4, 32)).astype(np.float32)
    k, ks = _cache(rng, 3, 64, 2, 32, int8)
    v, vs = _cache(rng, 3, 64, 2, 32, int8)
    pos = np.array([0, 9, 40], dtype=np.int32)
    opt = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(jatt.gqa_attention_per_slot(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        opt(ks), opt(vs)))
    topt = (lambda a: None if a is None else torch.from_numpy(a))
    got = tatt.gqa_attention_per_slot(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), topt(ks), topt(vs), live=41).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_masked_softmax_exact_zeros():
    scores = torch.tensor([[1.0, 2.0, float("nan"), 3.0]])
    mask = torch.tensor([[True, True, False, False]])
    p = tatt._masked_softmax(scores, mask)
    assert p[0, 2].item() == 0.0 and p[0, 3].item() == 0.0
    assert abs(p.sum().item() - 1.0) < 1e-6
