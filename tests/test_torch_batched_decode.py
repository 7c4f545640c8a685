"""The serving decode attention of the PyTorch port against the JAX
package's: batched_decode_partial's plain version (qwen3_tpu_torch/ops/cuda/
batched_decode.py) against the Pallas kernel in interpret mode, and the
port's fused_batched_attention and gqa_attention_two_segment against the JAX
functions, at tests/test_fused_attn.py's shapes (B=4, L=3, S=512, KV=2,
M=2, D=128, a side buffer of C=8 rows). Inputs are made with numpy and
handed to both packages; int8 caches through the JAX package's own KV
encode.

Tolerances. fast=False: 2e-5 relative to max|want| (both packages repeat
the same fp32 arithmetic; matmul order and exp differ in the last ulp).
fast=True rounds the dot operands to bf16 in both packages the same way,
and a product of two bf16 values is exact in fp32, so the scores and m are
held to the same 2e-5. But the value dot's operand p * vs (or the softmax
probabilities) is rounded to bf16 after an exp that may differ by an ulp
between the libraries: where it sits on a rounding boundary it moves by one
bf16 ulp, 2^-8 of itself. The value sums (acc, and the attention output;
not l, which sums the unrounded p) are therefore held to
2e-5 * max|want| + 2^-8 * max|v * vs|, one such flip at the largest value
(p <= 1, and the output's probabilities sum to 1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops import attention as jatt  # noqa: E402
from qwen3_tpu.ops.pallas.batched_decode import (  # noqa: E402
    batched_decode_partial as jax_partial,
)
from qwen3_tpu.runtime import kvcache as jkvc  # noqa: E402
from qwen3_tpu_torch.ops import attention as tatt  # noqa: E402
from qwen3_tpu_torch.ops.cuda import batched_decode as tbd  # noqa: E402

L, S, KV, M, D, C = 3, 512, 2, 2, 128, 8
H = KV * M
NEG = float(np.finfo(np.float32).min)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops, which gain nothing from
    intra-op threads and lose much to them when the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(B=4, seed=0, int8=False):
    """numpy inputs: q, main k/v (+ scales), side k/v (+ scales), base,
    offsets."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)

    def cache(shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        if not int8:
            return x, None
        xq, xs = jkvc.quantize_heads(jnp.asarray(x))
        return np.asarray(xq), np.asarray(xs)

    k, ks = cache((L, B, S, KV, D))
    v, vs = cache((L, B, S, KV, D))
    sk, sks = cache((B, C, KV, D))
    sv, svs = cache((B, C, KV, D))
    base = rng.integers(1, S, size=B).astype(np.int32)
    off = rng.integers(0, C, size=B).astype(np.int32)
    return q, k, v, ks, vs, sk, sv, sks, svs, base, off


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _vmax(v, vs):
    """max|v * vs|: the largest value a flipped bf16 rounding can scale."""
    f = v.astype(np.float32)
    return float(np.max(np.abs(f if vs is None else f * vs[..., None])))


def _close(got, want, fast, vmax):
    want = np.asarray(want)
    tol = 2e-5 * np.max(np.abs(want)) + (2.0 ** -8 * vmax if fast else 0.0)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= tol, (err, tol)


def _partials(q, k, v, ks, vs, layer, lim, bucket, fast):
    flat = (None, None) if ks is None else (
        jnp.asarray(ks.reshape(L, ks.shape[1], -1)),
        jnp.asarray(vs.reshape(L, vs.shape[1], -1)))
    want = jax_partial(_j(q), _j(k), _j(v), jnp.int32(layer), _j(lim),
                       flat[0], flat[1], bucket=bucket, fast=fast,
                       interpret=True)
    got = tbd.batched_decode_partial(_t(q), _t(k), _t(v), layer, _t(lim),
                                     _t(ks), _t(vs), bucket=bucket,
                                     fast=fast)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bucket", [256, 384, 512, None])
def test_partial_plain_matches_pallas(bucket, int8, fast):
    """acc, m and l, with row limits 1 and S among them (clipped to the
    bucket); bucket 384 takes the Pallas kernel's 128-row tile fallback."""
    q, k, v, ks, vs, *_ = _mk(int8=int8)
    lim = np.array([1, 37, 200, S], np.int32)
    if bucket is not None:
        lim = np.minimum(lim, bucket)
    (ja, jm, jl), (ta, tm, tl) = _partials(q, k, v, ks, vs, 1, lim, bucket,
                                           fast)
    assert ta.shape == (4, KV, M, D) and tm.shape == tl.shape == (4, KV, M)
    _close(tm, jm, False, 0.0)
    _close(tl, jl, False, 0.0)         # l sums the unrounded p
    _close(ta, ja, fast, _vmax(v[1], None if vs is None else vs[1]))


@pytest.mark.parametrize("fast", [False, True])
def test_partial_plain_matches_pallas_one_slot_per_step(fast):
    """B = 3 makes the Pallas kernel serve one slot per grid step (its
    `_pick_bb` finds no larger divisor); the port has no such tile."""
    q, k, v, ks, vs, *_ = _mk(B=3, seed=2, int8=True)
    lim = np.array([512, 3, 256], np.int32)
    (ja, jm, jl), (ta, tm, tl) = _partials(q, k, v, ks, vs, 2, lim, None,
                                           fast)
    _close(tm, jm, False, 0.0)
    _close(tl, jl, False, 0.0)
    _close(ta, ja, fast, _vmax(v[2], vs[2]))


def test_partial_with_no_rows_is_empty():
    """row_limit 0 (a slot never admitted, which the serving step still
    runs) gives acc 0, m finfo.min and l 0, as the Pallas kernel's masked
    tiles do."""
    q, k, v, ks, vs, *_ = _mk(int8=True)
    lim = np.array([0, 5, 0, 1], np.int32)
    (ja, jm, jl), (ta, tm, tl) = _partials(q, k, v, ks, vs, 0, lim, 256,
                                           True)
    for b in (0, 2):
        assert np.all(ta[b] == 0) and np.all(tl[b] == 0)
        assert np.all(tm[b] == NEG) and np.all(jm[b] == NEG)
    _close(ta, ja, True, _vmax(v[0], vs[0]))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_and_two_segment_match_jax(int8, fast):
    """The port's fused_batched_attention and gqa_attention_two_segment
    against the JAX functions on the same inputs (layer 2, every row of the
    main cache a candidate)."""
    q, k, v, ks, vs, sk, sv, sks, svs, base, off = _mk(seed=3, int8=int8)
    flat = None if ks is None else (jnp.asarray(ks.reshape(L, 4, -1)),
                                    jnp.asarray(vs.reshape(L, 4, -1)))
    want = jatt.fused_batched_attention(
        _j(q), _j(k), _j(v), _j(sk), _j(sv), _j(base), _j(off),
        k_ss=_j(sks), v_ss=_j(svs), scales_flat=flat, layer=2, bucket=None,
        fast=fast, interpret=True)
    got = tatt.fused_batched_attention(
        _t(q), _t(k), _t(v), _t(sk), _t(sv), _t(base), _t(off), _t(sks),
        _t(svs), k_ms=_t(ks), v_ms=_t(vs), layer=2, bucket=None, fast=fast)
    vmax = max(_vmax(v[2], None if vs is None else vs[2]), _vmax(sv, svs))
    _close(got.numpy(), want, fast, vmax)

    want = jatt.gqa_attention_two_segment(
        _j(q), _j(k), _j(v), _j(sk), _j(sv), _j(base), _j(off),
        k_ms=_j(ks), v_ms=_j(vs), k_ss=_j(sks), v_ss=_j(svs), fast=fast,
        layer=2)
    got = tatt.gqa_attention_two_segment(
        _t(q), _t(k[2]), _t(v[2]), _t(sk), _t(sv), _t(base), _t(off),
        None if ks is None else _t(ks[2]), None if vs is None else _t(vs[2]),
        _t(sks), _t(svs), fast=fast)
    _close(got.numpy(), want, fast, vmax)


@pytest.mark.parametrize("base_val", [0, 1])
def test_fused_zero_main_rows(base_val):
    """Slots with no main row (base 0: a slot never admitted) or one, plus
    side rows, stay finite and match the JAX fused function."""
    q, k, v, ks, vs, sk, sv, sks, svs, _, off = _mk(seed=5)
    base = np.full(4, base_val, np.int32)
    want = jatt.fused_batched_attention(
        _j(q), _j(k), _j(v), _j(sk), _j(sv), _j(base), _j(off), layer=0,
        bucket=256, fast=False, interpret=True)
    got = tatt.fused_batched_attention(
        _t(q), _t(k), _t(v), _t(sk), _t(sv), _t(base), _t(off), layer=0,
        bucket=256, fast=False)
    assert torch.isfinite(got).all()
    _close(got.numpy(), want, False, 0.0)
    two = tatt.gqa_attention_two_segment(
        _t(q), _t(k[0]), _t(v[0]), _t(sk), _t(sv), _t(base), _t(off),
        live=base_val)
    _close(got.numpy(), two.numpy(), False, 0.0)


@pytest.mark.parametrize("int8", [False, True])
def test_bucket_and_live_change_no_value(int8):
    """The bucket bounds the rows read (rows past every limit are masked to
    an exact 0), and the dense function's `live` likewise."""
    q, k, v, ks, vs, sk, sv, sks, svs, base, off = _mk(seed=6, int8=int8)
    base = np.array([3, 100, 40, 255], np.int32)
    outs = [tatt.fused_batched_attention(
        _t(q), _t(k), _t(v), _t(sk), _t(sv), _t(base), _t(off), _t(sks),
        _t(svs), k_ms=_t(ks), v_ms=_t(vs), layer=1, bucket=bucket,
        fast=True) for bucket in (256, None)]
    _close(outs[0].numpy(), outs[1].numpy(), False, 0.0)
    dense = [tatt.gqa_attention_two_segment(
        _t(q), _t(k[1]), _t(v[1]), _t(sk), _t(sv), _t(base), _t(off),
        None if ks is None else _t(ks[1]), None if vs is None else _t(vs[1]),
        _t(sks), _t(svs), fast=True, live=live) for live in (255, None)]
    assert torch.equal(dense[0], dense[1])


def test_cpu_tensors_take_plain_version_and_cuda_path_refuses():
    q, k, v, ks, vs, *_ = _mk(int8=True)
    lim = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    tbd.reset_launches()
    got = tbd.batched_decode_partial(_t(q), _t(k), _t(v), 0, lim, _t(ks),
                                     _t(vs), bucket=256)
    want = tbd.batched_decode_plain(_t(q), _t(k), _t(v), 0, lim, _t(ks),
                                    _t(vs), bucket=256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tbd.LAUNCHES == {"batched_decode_partial": 0}
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (_t(q), _t(k), _t(v), lim)]
    with pytest.raises(ValueError, match="must be on"):
        tbd.batched_decode_partial(*meta[:3], 0, meta[3], bucket=None)
