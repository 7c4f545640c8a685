"""The port's device xorshift and B = 1 decode chunk
(runtime/decode_loop.py::decode_chunk) against the JAX package's, on the CPU
(the JAX package's Pallas kernels in interpret mode), on preset tiny (tiny8:
test_torch_decode_chunk_tiny8.py).

The chunk cases are torch_chunk_parity.run_chunks: a 16-token prefill, then
chunks of 8 held equal after each. The prefill's token seed (0) and the RNG
seed (5) are ones where no Q8 activation or int8 K/V rounding flips between
the packages on these inputs (ROADMAP.md, Queue C #1); flash flips most
often, as in test_torch_forward.py. The stop case picks its stop id from
the free-running stream, so that the stream stops at its fourth step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.runtime import xorshift as jxs  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tq  # noqa: E402
from qwen3_tpu_torch.runtime import kvcache as tkvc  # noqa: E402
from qwen3_tpu_torch.runtime import xorshift as txs  # noqa: E402
from qwen3_tpu_torch.runtime.decode_loop import (  # noqa: E402
    chunk_steps,
    decode_chunk,
    decode_chunk_host,
)
from torch_chunk_parity import (  # noqa: E402
    CHUNK,
    PROMPT,
    ROWS,
    params,
    prefilled,
    run_chunks,
    stop_inside_chunk,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(n=10_000):
    """n (hi, lo) uint32 pairs: random, a quarter with hi's top bit set,
    every seventh with lo's, and the edges."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64)
    hi[: n // 4] |= np.uint64(1 << 31)
    lo[::7] |= np.uint64(1 << 31)
    hi[-4:] = [2**32 - 1, 2**31, 0, 2**32 - 1]
    lo[-4:] = [2**32 - 1, 0, 1, 2**32 - 2]
    return hi, lo


def test_device_xorshift_matches_jax_device_and_host():
    """10^4 states through one step: the port's (hi, lo, out) and coin
    equal JAX's uint32 device functions and the host oracle, bit for bit."""
    hi, lo = _states()
    th, tl, tout = txs.xorshift_step_device(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)))
    jh, jl, jout = jax.jit(jxs.xorshift_step_device)(
        jnp.asarray(hi, jnp.uint32), jnp.asarray(lo, jnp.uint32))
    for got, want in ((th, jh), (tl, jl), (tout, jout)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    _, _, tcoin = txs.xorshift_coin_device(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)))
    _, _, jcoin = jax.jit(jxs.xorshift_coin_device)(
        jnp.asarray(hi, jnp.uint32), jnp.asarray(lo, jnp.uint32))
    assert tcoin.dtype == torch.float32
    assert np.array_equal(tcoin.numpy().view(np.uint32),
                          np.asarray(jcoin).view(np.uint32))
    for h, lw, nh, nl, out, coin in zip(hi, lo, th, tl, tout, tcoin):
        state = (int(h) << 32) | int(lw)
        want_state, want_out = jxs.xorshift_step(state)
        assert ((int(nh) << 32) | int(nl), int(out)) == (want_state,
                                                         want_out)
        assert float(coin) == jxs.xorshift_float(state)[1]


@pytest.mark.parametrize("seed", [0, 3, 0x9E3779B97F4A7C15, 2**64 - 1,
                                  1 << 63, 2**64 + 5, -1])
def test_device_state_conversions_are_exact(seed):
    hi, lo = txs.seed_to_device(seed, "cpu")
    jhi, jlo = jxs.seed_to_device(seed)
    assert (int(hi), int(lo)) == (int(jhi), int(jlo))
    assert hi.dtype == lo.dtype == torch.int64 and hi.dim() == 0
    state = seed & (2**64 - 1)
    assert txs.from_device_state(hi, lo) == state
    assert txs.from_device_state(*txs.to_device_state(state, "cpu")) == state
    # a run of draws stays the host stream's
    rng = txs.XorshiftRng(state)
    for _ in range(20):
        hi, lo, coin = txs.xorshift_coin_device(hi, lo)
        assert float(coin) == rng.next_float()
    assert txs.from_device_state(hi, lo) == rng.state


def test_chunk_steps():
    assert chunk_steps(16, 100, 8) == 8
    assert chunk_steps(16, 21, 8) == 6         # 5 emitted, then the limit
    assert chunk_steps(16, 23, 8) == 8
    assert chunk_steps(16, 16, 8) == 1
    assert chunk_steps(20, 16, 8) == 1


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("mode", ["pallas", "exact"])
def test_decode_chunk_matches_jax(mode, attn, sampling):
    """Two chunks against a limit at 16 + 8 + 5: the first runs free, the
    second meets the limit, which mode exact's cases emit (chat's
    emit_at_limit) and mode pallas's do not (completion)."""
    emit = mode == "exact"
    emitted = run_chunks("tiny", mode, attn,
                         temperature=0.0 if sampling == "greedy" else 0.8,
                         limit=PROMPT + CHUNK + 5, emit_at_limit=emit,
                         chunks=3)
    assert len(emitted) == CHUNK + 5 + emit


def test_decode_chunk_stop_inside_chunk_matches_jax():
    stop_inside_chunk("tiny", "pallas")


def test_decode_chunk_at_the_cache_end():
    """A stream whose limit is the cache's row count: the last step's
    forward runs at the clamped position (JAX's safe_pos) and the chunk
    ends at the limit, as JAX's does."""
    run_chunks("tiny", "pallas", "dense", temperature=0.8, limit=ROWS,
               emit_at_limit=False, chunks=7)


def test_device_position_forward_needs_one_token_and_live():
    cfg, _, tp = params("tiny", "pallas")
    k, v = tq.init_kv_cache(cfg, 1, ROWS, "int8", "cpu")
    pos = torch.tensor(3)
    with pytest.raises(ValueError, match="live"):
        tq.forward(tp, cfg, torch.zeros(1, 1, dtype=torch.int64), k, v, pos)
    with pytest.raises(ValueError, match="live"):
        tq.forward(tp, cfg, torch.zeros(1, 2, dtype=torch.int64), k, v, pos,
                   live=4)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_device_position_forward_equals_host_position(attn):
    """forward at a device position gives the host-int path's logits and
    rows bit for bit (the same ops, the same `live`)."""
    cfg, _, tp = params("tiny", "pallas")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PROMPT)))
    caches = []
    for _ in range(2):
        k, v = tq.init_kv_cache(cfg, 1, ROWS, "int8", "cpu")
        tq.forward(tp, cfg, toks, k, v, 0)
        caches.append((k, v))
    (hk, hv), (dk, dv) = caches
    tok = torch.tensor([[7]])
    want, _, _ = tq.forward(tp, cfg, tok, hk, hv, PROMPT, attn=attn)
    got, _, _ = tq.forward(tp, cfg, tok, dk, dv, torch.tensor(PROMPT),
                           attn=attn, live=PROMPT + 1)
    assert torch.equal(got, want)
    for a, b in zip(tkvc.tensors(hk) + tkvc.tensors(hv),
                    tkvc.tensors(dk) + tkvc.tensors(dv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["free", "stop", "limit", "emit", "end"])
def test_decode_chunk_equals_its_host_loop(case):
    """decode_chunk against decode_chunk_host (the JAX loop with a host read
    after each step, the card's check in chip_smoke.py) on the CPU, bit for
    bit: packed, token, position, RNG and every KV row below the position;
    a free chunk, a stop at the fourth step, the limit without and with
    emit_at_limit, and a limit at the cache's last row + 1."""
    cfg, _, tp = params("tiny", "pallas")
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT)))
    pos0 = ROWS - 3 if case == "end" else PROMPT
    limit = {"free": ROWS, "stop": ROWS, "limit": PROMPT + 5,
             "emit": PROMPT + 5, "end": ROWS}[case]
    kw = dict(mode="pallas", chunk=CHUNK, temperature=0.8, top_p=0.9,
              greedy=False, bos=cfg.vocab_size - 1, eos=cfg.vocab_size - 2,
              emit_at_limit=case in ("emit", "end"), top_k=64)

    def prefilled_cache():
        k, v = tq.init_kv_cache(cfg, 1, ROWS, "int8", "cpu")
        tq.forward(tp, cfg, toks, k, v, 0)
        return k, v

    if case == "stop":         # the free stream's fourth id stops it
        kw["eos"] = int(decode_chunk_host(
            tp, cfg, *prefilled_cache(), 7, pos0, limit, 5, **kw)[0][3])
    (hk, hv), (dk, dv) = prefilled_cache(), prefilled_cache()
    packed, hk, hv, token, pos, rng = decode_chunk_host(
        tp, cfg, hk, hv, 7, pos0, limit, 5, **kw)
    hi, lo = txs.seed_to_device(5, "cpu")
    dpacked, dk, dv, dtok, dpos, hi, lo = decode_chunk(
        tp, cfg, dk, dv, torch.tensor([7]), pos0, limit, hi, lo, **kw)
    assert dpacked.tolist() == packed.tolist()
    assert (int(dtok[0]), int(dpos), txs.from_device_state(hi, lo)) == (
        token, pos, rng)
    n = int(packed[-2])
    assert pos == min(pos0 + n, limit)
    assert bool(packed[-1]) == (case != "free")
    if case == "stop":
        assert n == 3
    for a, b in zip(tkvc.tensors(hk) + tkvc.tensors(hv),
                    tkvc.tensors(dk) + tkvc.tensors(dv)):
        assert torch.equal(a[:, :, :pos], b[:, :, :pos])
