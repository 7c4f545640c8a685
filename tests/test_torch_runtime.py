"""The PyTorch port's sampler, RNG and prefill plan against the JAX
package's, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.runtime import decode_loop as jdl  # noqa: E402
from qwen3_tpu.runtime import sampler as jsamp  # noqa: E402
from qwen3_tpu.runtime import xorshift as jxs  # noqa: E402
from qwen3_tpu_torch.runtime import decode_loop as tdl  # noqa: E402
from qwen3_tpu_torch.runtime import sampler as tsamp  # noqa: E402
from qwen3_tpu_torch.runtime import xorshift as txs  # noqa: E402


def test_xorshift_matches_jax_host_and_device():
    seed = 0x9E3779B97F4A7C15
    jr, tr = jxs.XorshiftRng(seed), txs.XorshiftRng(seed)
    hi, lo = jxs.seed_to_device(seed)
    for _ in range(50):
        coin = tr.next_float()
        assert coin == jr.next_float()
        hi, lo, c = jxs.xorshift_coin_device(hi, lo)
        assert coin == float(c)


@pytest.mark.parametrize("t,p", [(0.0, 0.9), (float("nan"), 2.0),
                                 (-1.0, -1.0), (0.7, float("inf"))])
def test_clamps_match(t, p):
    assert tsamp.clamp_temperature(t) == jsamp.clamp_temperature(t)
    assert tsamp.clamp_top_p(p) == jsamp.clamp_top_p(p)


@pytest.fixture(scope="module")
def jax_sample():
    """jax.jit(sample_tokens): `greedy` static when a python bool, traced
    when a per-row array."""
    static = jax.jit(jsamp.sample_tokens,
                     static_argnames=("greedy", "top_k_hint"))
    traced = jax.jit(jsamp.sample_tokens, static_argnames=("top_k_hint",))

    def run(*args, greedy, top_k_hint):
        fn = static if isinstance(greedy, bool) else traced
        return fn(*args, greedy=greedy, top_k_hint=top_k_hint)

    return run


@pytest.mark.parametrize("spread,top_k", [(0.3, 64), (4.0, 64), (4.0, 0),
                                          (0.3, 0)])
def test_sample_tokens_match_jax(jax_sample, spread, top_k):
    """Flat logits (the top-64 prefix holds less than top_p: full sort) and
    peaked ones (the top-k fast path), each with and without the hint, per
    row temperatures and top_p, and a tie block, over many coins."""
    rng = np.random.default_rng(int(spread * 10) + top_k)
    B, V = 6, 512
    logits = (rng.standard_normal((B, V)) * spread).astype(np.float32)
    logits[0, 10:20] = logits[0].max()          # ties: lower id first
    temp = np.array([0.8, 1.0, 0.5, 1.3, 0.8, 1e-6], np.float32)
    topp = np.array([0.9, 0.5, 0.99, 1.0, 1e-6, 0.9], np.float32)
    for _ in range(20):
        coin = rng.random(B).astype(np.float32)
        want = np.asarray(jax_sample(
            jnp.asarray(logits), jnp.asarray(coin), jnp.asarray(temp),
            jnp.asarray(topp), greedy=jnp.asarray(temp <= 1e-6),
            top_k_hint=top_k))
        got = tsamp.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(coin),
            torch.from_numpy(temp), torch.from_numpy(topp),
            greedy=torch.from_numpy(temp <= 1e-6), top_k_hint=top_k).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_tokens_scalar_params_and_greedy(jax_sample):
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((3, 300)) * 2).astype(np.float32)
    coin = rng.random(3).astype(np.float32)
    for greedy in (False, True):
        want = np.asarray(jax_sample(jnp.asarray(logits), jnp.asarray(coin),
                                     0.8, 0.9, greedy=greedy,
                                     top_k_hint=64))
        got = tsamp.sample_tokens(torch.from_numpy(logits),
                                  torch.from_numpy(coin), 0.8, 0.9,
                                  greedy=greedy, top_k_hint=64).numpy()
        np.testing.assert_array_equal(got, want)


def test_host_sampler_matches_jax():
    rng = np.random.default_rng(10)
    js = jsamp.Sampler(512, 0.9, 0.8, 77)
    ts = tsamp.Sampler(512, 0.9, 0.8, 77)
    for _ in range(30):
        lg = (rng.standard_normal(512) * 2).astype(np.float32)
        assert ts.sample_host(lg) == js.sample_host(lg)


def test_burn_and_sample_matches_jax():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal(512) * 2).astype(np.float32)
    seed = 1234567
    hi, lo = jxs.seed_to_device(seed)
    for n_burn in (0, 1, 13):
        jt, jhi, jlo = jdl.burn_and_sample(
            jnp.asarray(logits), hi, lo, jnp.int32(n_burn),
            jnp.float32(0.8), jnp.float32(0.9), greedy=False, top_k=64)
        tt, state = tdl.burn_and_sample(torch.from_numpy(logits), seed,
                                        n_burn, 0.8, 0.9, greedy=False,
                                        top_k=64)
        assert tt == int(jt[0])
        assert state == (int(jhi) << 32) | int(jlo)


def test_prefill_plan_matches_jax():
    for n in (1, 10, 64, 65, 127, 128, 300, 511, 512, 513, 1100, 1500):
        for start in (0, 5, 100):
            for seq in (128, 600, 4096):
                if start >= seq:
                    continue
                assert (tdl.prefill_plan(n, start, 64, seq)
                        == jdl.prefill_plan(n, start, 64, seq))
    ids = list(range(150))
    assert (list(tdl.prefill_blocks(ids, 3, 64, 4096))
            == list(jdl.prefill_blocks(ids, 3, 64, 4096)))


@pytest.mark.parametrize("n", [1, 64, 511, 512, 1500, 151936])
def test_blocked_cumsum_matches_sequential(n):
    """The card's scan in its fixed tiled order (cumsum_ordered, the prefix
    sum kernel's plain version) against the float64 prefix sum, across tile
    edges and at the full vocabulary, and the same bits on every call; on
    the CPU cumsum_last stays torch.cumsum itself."""
    from qwen3_tpu_torch.ops.cuda import sampler as cs

    rng = np.random.default_rng(n)
    p = rng.random((2, n)).astype(np.float32)
    p /= p.sum(axis=-1, keepdims=True)
    x = torch.from_numpy(p)
    got = cs.cumsum_ordered(x)
    assert got.shape == x.shape and got.dtype == torch.float32
    want = np.cumsum(p.astype(np.float64), axis=-1)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-6
    assert torch.equal(got, cs.cumsum_ordered(x))
    assert torch.equal(tsamp.cumsum_last(x), torch.cumsum(x, dim=-1))


def test_log_matches_jax(capsys, monkeypatch):
    """utils.log writes the JAX package's `[Component] msg` stderr line;
    QWEN3_TPU_QUIET=1, read by an entry point (config.quiet_from_env) and
    passed to set_quiet, silences both."""
    import qwen3_tpu.utils.logging as jlog

    from qwen3_tpu_torch import utils as tutils
    from qwen3_tpu_torch.config import quiet_from_env
    from qwen3_tpu_torch.utils import logging as tlog

    monkeypatch.setattr(jlog, "_QUIET", False)
    jlog.log("Engine", "loading x.bin (mode=pallas)")
    want = capsys.readouterr()
    tutils.log("Engine", "loading x.bin (mode=pallas)")
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert got.err == "[Engine] loading x.bin (mode=pallas)\n"
    assert tutils.profile_trace.__module__ == "qwen3_tpu_torch.utils.profiling"

    assert quiet_from_env({"QWEN3_TPU_QUIET": "1"})
    assert not quiet_from_env({}) and not quiet_from_env(
        {"QWEN3_TPU_QUIET": "0"})
    monkeypatch.setattr(jlog, "_QUIET", True)
    try:
        tlog.set_quiet(quiet_from_env({"QWEN3_TPU_QUIET": "1"}))
        jlog.log("Serve", "x")
        tlog.log("Serve", "x")
        assert capsys.readouterr().err == ""
    finally:
        tlog.set_quiet(False)
