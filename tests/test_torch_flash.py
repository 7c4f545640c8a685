"""The flash attention kernels' plain versions (qwen3_tpu_torch/ops/cuda/
flash_decode.py) against the JAX package's Pallas kernels in interpret mode,
at tests/test_flash.py's shapes: fp32, bf16 and int8 caches, positions at
the tile edges (0, ts-1, ts, S-1) and prefill blocks that start at 0, across
a tile boundary and at the end of the cache; the serving engine's
two-segment decode with base positions 0, 1, 255, 256 and S-1 and side
offsets across the chunk.

Tolerance 2e-5 (rtol and atol), the JAX package's own for its flash kernels:
the plain versions repeat the Pallas kernels' arithmetic, and the two
libraries' fp32 matmuls and exp differ in the last ulp. The cache is made
with numpy and handed to both packages (bf16 rounds to nearest even in
both)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.pallas import flash_decode as jfd  # noqa: E402
from qwen3_tpu_torch.ops import attention as tatt  # noqa: E402
from qwen3_tpu_torch.ops.cuda import flash_decode as tfd  # noqa: E402

B, H, KV, D, S, TS = 3, 4, 2, 64, 512, 256
TOL = dict(rtol=2e-5, atol=2e-5)


def _cache(seed, dtype):
    """-> ((jax values, jax scales), (torch values, torch scales))."""
    f = np.random.default_rng(seed).standard_normal(
        (B, S, KV, D)).astype(np.float32)
    if dtype == "int8":
        s = (np.abs(f).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
        q = np.clip(np.round(f / s[..., None]), -127, 127).astype(np.int8)
        return ((jnp.asarray(q), jnp.asarray(s)),
                (torch.from_numpy(q), torch.from_numpy(s)))
    jv = jnp.asarray(f, dtype=jnp.dtype(dtype))
    tv = torch.from_numpy(f).to(getattr(torch, dtype))
    return (jv, None), (tv, None)


def _caches(dtype, seed):
    (jk, jks), (tk, tks) = _cache(seed, dtype)
    (jv, jvs), (tv, tvs) = _cache(seed + 1, dtype)
    return (jk, jv, jks, jvs), (tk, tv, tks, tvs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pos_set", [[0, TS - 1, TS], [TS, S - 1, 5]])
def test_decode_plain_matches_pallas(dtype, pos_set):
    q = np.random.default_rng(0).standard_normal((B, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _caches(dtype, 10)
    want = jfd.flash_decode_gqa(jnp.asarray(q), jk, jv,
                                jnp.asarray(pos_set, jnp.int32), jks, jvs,
                                block_s=TS, interpret=True)
    got = tfd.flash_decode_plain(torch.from_numpy(q), tk, tv,
                                 torch.tensor(pos_set), tks, tvs, block_s=TS)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("start", [0, TS - 16, S - 32])
def test_prefill_plain_matches_pallas(dtype, start):
    """T = 32 query rows in query tiles of 16 (block_t)."""
    T = 32
    q = np.random.default_rng(7).standard_normal(
        (B, T, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _caches(dtype, 20)
    pos = start + np.arange(T)
    want = jfd.flash_prefill_gqa(jnp.asarray(q), jk, jv,
                                 jnp.asarray(pos, jnp.int32), jks, jvs,
                                 block_s=TS, block_t=16, interpret=True)
    got = tfd.flash_prefill_plain(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(pos), tks, tvs,
                                  block_s=TS, block_t=16)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_matches_dense(dtype):
    """The plain versions against the port's dense masked-softmax attention
    (the same values up to the online softmax's fp32 order), and `live`
    bounds the tile loop without changing a bit."""
    rng = np.random.default_rng(3)
    _, (tk, tv, tks, tvs) = _caches(dtype, 30)
    q1 = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    pos = torch.tensor([0, TS, S - 1])
    got = tfd.flash_decode_plain(q1, tk, tv, pos, tks, tvs)
    want = tatt.gqa_attention_per_slot(q1, tk, tv, pos, tks, tvs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    pos = torch.tensor([3, TS + 1, 9])
    assert torch.equal(tfd.flash_decode_plain(q1, tk, tv, pos, tks, tvs,
                                              live=TS + 2),
                       tfd.flash_decode_plain(q1, tk, tv, pos, tks, tvs))

    T = 48
    qt = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(
        np.float32))
    qpos = torch.arange(TS - 20, TS - 20 + T)
    got = tfd.flash_prefill_plain(qt, tk, tv, qpos, tks, tvs, block_t=16)
    want = tatt.gqa_attention(qt, tk, tv, qpos, tks, tvs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert torch.equal(tfd.flash_prefill_plain(qt, tk, tv, qpos, tks, tvs,
                                               block_t=16, live=TS + 28),
                       got)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_wrappers_on_cpu_run_the_plain_versions(dtype):
    """A CPU tensor takes the plain version (bit for bit) and launches
    nothing."""
    rng = np.random.default_rng(4)
    _, (tk, tv, tks, tvs) = _caches(dtype, 40)
    q1 = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    qt = torch.from_numpy(rng.standard_normal((B, 8, H, D)).astype(
        np.float32))
    pos = torch.tensor([1, 300, 511], dtype=torch.int32)
    qpos = torch.arange(250, 258, dtype=torch.int32)
    tfd.reset_launches()
    assert torch.equal(
        tfd.flash_decode_gqa(q1, tk, tv, pos, tks, tvs, live=512),
        tfd.flash_decode_plain(q1, tk, tv, pos, tks, tvs))
    assert torch.equal(
        tfd.flash_prefill_gqa(qt, tk, tv, qpos, tks, tvs),
        tfd.flash_prefill_plain(qt, tk, tv, qpos, tks, tvs))
    sk, sv, sks, svs = _side(dtype, 41)
    base = torch.tensor([0, 256, 511], dtype=torch.int32)
    off = torch.tensor([3, 0, SIDE_C - 1], dtype=torch.int32)
    assert torch.equal(
        tfd.flash_decode_gqa_two_segment(q1, tk, tv, sk, sv, base, off, tks,
                                         tvs, sks, svs, live=511),
        tfd.flash_decode_two_segment_plain(q1, tk, tv, sk, sv, base, off,
                                           tks, tvs, sks, svs))
    assert tfd.LAUNCHES == {"flash_decode": 0, "flash_prefill": 0,
                            "flash_decode_two_segment": 0}


SIDE_C = 32     # the serving engine's decode chunk


def _side(dtype, seed):
    """A side buffer [B, SIDE_C, KV, D] for K and V (torch), as _caches."""
    out = []
    for i in range(2):
        f = np.random.default_rng(seed + i).standard_normal(
            (B, SIDE_C, KV, D)).astype(np.float32)
        if dtype == "int8":
            sc = (np.abs(f).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
            q = np.clip(np.round(f / sc[..., None]), -127, 127)
            out.append((torch.from_numpy(q.astype(np.int8)),
                        torch.from_numpy(sc)))
        else:
            out.append((torch.from_numpy(f).to(getattr(torch, dtype)), None))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("base_set,off_set", [([0, 255, 256], [0, 31, 17]),
                                              ([1, S - 1, 100], [5, 0, 31])])
def test_two_segment_plain_matches_pallas(dtype, base_set, off_set):
    """Main rows < base_pos (base 0 reads no main tile; 255 and 256 sit at
    the tile edge) and side rows <= offsets, under one softmax."""
    q = np.random.default_rng(8).standard_normal((B, H, D)).astype(
        np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _caches(dtype, 50)
    sk, sv, sks, svs = _side(dtype, 60)
    jside = [None if t is None else jnp.asarray(
        t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
        dtype=jnp.bfloat16 if t.dtype == torch.bfloat16 else None)
        for t in (sk, sv, sks, svs)]
    base, off = np.array(base_set), np.array(off_set)
    want = jfd.flash_decode_gqa_two_segment(
        jnp.asarray(q), jk, jv, jside[0], jside[1],
        jnp.asarray(base, jnp.int32), jnp.asarray(off, jnp.int32), jks, jvs,
        jside[2], jside[3], block_s=TS, interpret=True)
    got = tfd.flash_decode_two_segment_plain(
        torch.from_numpy(q), tk, tv, sk, sv, torch.from_numpy(base),
        torch.from_numpy(off), tks, tvs, sks, svs, block_s=TS)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # `live` (max base_pos) bounds the tile loop without changing a bit
    assert torch.equal(tfd.flash_decode_two_segment_plain(
        torch.from_numpy(q), tk, tv, sk, sv, torch.from_numpy(base),
        torch.from_numpy(off), tks, tvs, sks, svs, block_s=TS,
        live=int(base.max())), got)


def test_two_segment_plain_matches_dense_two_segment():
    """Against the port's dense two-segment attention: the same values up
    to the online softmax's fp32 order."""
    rng = np.random.default_rng(9)
    _, (tk, tv, tks, tvs) = _caches("int8", 70)
    sk, sv, sks, svs = _side("int8", 80)
    q1 = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    base = torch.tensor([0, 300, 512])
    off = torch.tensor([0, 7, SIDE_C - 1])
    got = tfd.flash_decode_two_segment_plain(q1, tk, tv, sk, sv, base, off,
                                             tks, tvs, sks, svs)
    want = tatt.gqa_attention_two_segment(q1, tk, tv, sk, sv, base, off,
                                          tks, tvs, sks, svs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("S_,block", [(8448, 256), (8224, 256), (64, 256),
                                      (512, 128), (300, 256)])
def test_pick_ts_matches_pallas(S_, block):
    """The S-tile rule without the TPU's int8 guard (the prefill's query
    tile follows it too)."""
    assert tfd.pick_ts(S_, block) == jfd._pick_ts(S_, block, False)
    assert [tfd.pick_ts(T, 64) for T in (64, 512, 96, 7)] == [64, 64, 32, 7]


def test_reads_a_cache_written_by_the_jax_forward():
    """The int8 cache layout is the JAX package's: a cache written by its
    forward (mode pallas, tiny), carried over with numpy, gives the JAX
    flash kernels' outputs through the port's flash path."""
    from qwen3_tpu.config import PRESETS
    from qwen3_tpu.io.synthetic import synthetic_weights
    from qwen3_tpu.models.qwen3 import forward, init_kv_cache, init_params

    cfg = PRESETS["tiny"]
    rows, n = 256, 40
    jp = init_params(synthetic_weights(cfg, seed=5), mode="pallas",
                     max_seq_len=rows)
    jk, jvc = init_kv_cache(cfg, 1, rows, jnp.int8)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, n))
    _, jk, jvc = forward(jp, cfg, jnp.asarray(toks, jnp.int32), jk, jvc,
                         jnp.int32(0), mode="pallas")
    rng = np.random.default_rng(6)
    Hq, Dq = cfg.n_heads, cfg.head_dim
    for layer in range(cfg.n_layers):
        jl = [a[layer] for a in (jk[0], jvc[0], jk[1], jvc[1])]
        tl = [torch.from_numpy(np.array(a)) for a in jl]
        q1 = rng.standard_normal((1, Hq, Dq)).astype(np.float32)
        want = jfd.flash_decode_gqa(jnp.asarray(q1), jl[0], jl[1],
                                    jnp.asarray([n - 1], jnp.int32), jl[2],
                                    jl[3], interpret=True)
        got = tfd.flash_decode_gqa(torch.from_numpy(q1), tl[0], tl[1],
                                   torch.tensor([n - 1]), tl[2], tl[3])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        qt = rng.standard_normal((1, 16, Hq, Dq)).astype(np.float32)
        pos = np.arange(n - 16, n)
        want = jfd.flash_prefill_gqa(jnp.asarray(qt), jl[0], jl[1],
                                     jnp.asarray(pos, jnp.int32), jl[2],
                                     jl[3], interpret=True)
        got = tfd.flash_prefill_gqa(torch.from_numpy(qt), tl[0], tl[1],
                                    torch.from_numpy(pos), tl[2], tl[3])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
