"""Shared by the decode-chunk parity tests (test_torch_decode_chunk*.py):
both packages' caches after one 16-token prefill into a 64-row cache on the
same weights (params_from_jax), and chunks of 8 from position 16 run in both
and held equal after every chunk: `packed`, the token, the position and the
RNG state, and every KV row below the position within the forward tests'
1e-5 of its largest value."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from qwen3_tpu.config import PRESETS
from qwen3_tpu.io.synthetic import synthetic_weights
from qwen3_tpu.models.qwen3 import forward as jax_forward
from qwen3_tpu.models.qwen3 import init_kv_cache as jax_init_kv
from qwen3_tpu.models.qwen3 import init_params
from qwen3_tpu.runtime import xorshift as jxs
from qwen3_tpu.runtime.decode_loop import decode_chunk as jax_decode_chunk
from qwen3_tpu_torch.models import qwen3 as tq
from qwen3_tpu_torch.runtime import kvcache as tkvc
from qwen3_tpu_torch.runtime import xorshift as txs
from qwen3_tpu_torch.runtime.decode_loop import decode_chunk

ROWS, PROMPT, CHUNK = 64, 16, 8
KV = {"tiny": "int8", "tiny8": "float32"}


@functools.lru_cache(maxsize=None)
def params(preset, mode):
    cfg = PRESETS[preset]
    jp = init_params(synthetic_weights(cfg, seed=0), mode=mode,
                     max_seq_len=ROWS)
    tp = tq.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    return cfg, jp, tp


def prefilled(preset, mode, tok_seed):
    """Both packages' caches after one 16-token prefill, and its greedy
    next token."""
    cfg, jp, tp = params(preset, mode)
    toks = np.random.default_rng(tok_seed).integers(0, cfg.vocab_size,
                                                    (1, PROMPT))
    kv = KV[preset]
    jk, jv = jax_init_kv(cfg, 1, ROWS, jnp.dtype(kv))
    jl, jk, jv = jax_forward(jp, cfg, jnp.asarray(toks, jnp.int32), jk, jv,
                             jnp.int32(0), mode=mode)
    tk, tv = tq.init_kv_cache(cfg, 1, ROWS, kv, "cpu")
    _, tk, tv = tq.forward(tp, cfg, torch.from_numpy(toks), tk, tv, 0,
                           mode=mode)
    first = int(np.argmax(np.asarray(jl)[0, -1]))
    return cfg, jp, tp, (jk, jv), (tk, tv), first


def fp32(cache) -> np.ndarray:
    vals, sc = (cache if isinstance(cache, tuple) else (cache, None))
    vals = np.asarray(vals, np.float32)
    return vals if sc is None else vals * np.asarray(sc)[..., None]


def rows_close(got_cache, want_cache, pos):
    got = fp32(tuple(t.numpy() for t in tkvc.tensors(got_cache))
               if isinstance(got_cache, tuple) else got_cache.numpy())
    want = fp32(want_cache)
    got, want = got[:, :, :pos], want[:, :, :pos]
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def run_chunks(preset, mode, attn, *, temperature, limit, emit_at_limit,
               chunks, rng_seed=5, eos=None, tok_seed=0):
    """`chunks` chunks from position 16 in both packages, held equal after
    each (see the module docstring); returns the port's emitted ids."""
    cfg, jp, tp, (jk, jv), (tk, tv), first = prefilled(preset, mode,
                                                       tok_seed)
    kw = dict(mode=mode, chunk=CHUNK,
              temperature=max(temperature, 1e-6), top_p=0.9,
              greedy=temperature == 0.0, bos=cfg.vocab_size - 1,
              eos=cfg.vocab_size - 2 if eos is None else eos,
              emit_at_limit=emit_at_limit, top_k=64, attn=attn)
    jh, jlo = jxs.seed_to_device(rng_seed)
    jtok, jpos = jnp.asarray([first], jnp.int32), jnp.int32(PROMPT)
    th, tlo = txs.seed_to_device(rng_seed, "cpu")
    ttok, pos = torch.tensor([first]), PROMPT
    emitted = []
    for _ in range(chunks):
        jpk, jk, jv, jtok, jpos, jh, jlo = jax_decode_chunk(
            jp, jk, jv, jtok, jpos, jnp.int32(limit), jh, jlo, cfg=cfg, **kw)
        pk, tk, tv, ttok, tpos, th, tlo = decode_chunk(
            tp, cfg, tk, tv, ttok, pos, limit, th, tlo, **kw)
        assert pk.dtype == torch.int32 and pk.shape == (CHUNK + 2,)
        assert pk.tolist() == np.asarray(jpk).tolist()
        assert int(ttok[0]) == int(jtok[0])
        n = int(pk[-2])
        pos = min(pos + n, limit)
        assert int(tpos) == int(jpos) == pos
        assert txs.from_device_state(th, tlo) == (int(jh) << 32) | int(jlo)
        for got, want in ((tk, jk), (tv, jv)):
            rows_close(got, want, pos)
        emitted += pk[:n].tolist()
        if bool(pk[-1]):
            break
    return emitted


def stop_inside_chunk(preset, mode):
    """A stop token drawn at the fourth step: the chunk returns three ids
    and done, its later steps frozen, as JAX's loop ends there."""
    cfg, _, tp, _, (tk, tv), first = prefilled(preset, mode, 0)
    hi, lo = txs.seed_to_device(5, "cpu")
    packed = decode_chunk(
        tp, cfg, tk, tv, torch.tensor([first]), PROMPT, ROWS, hi, lo,
        mode=mode, chunk=CHUNK, temperature=0.8, top_p=0.9, greedy=False,
        bos=cfg.vocab_size - 1, eos=cfg.vocab_size - 2, top_k=64)[0]
    free = packed[:CHUNK].tolist()
    stop = free[3]
    assert stop not in free[:3]
    emitted = run_chunks(preset, mode, "dense", temperature=0.8, limit=ROWS,
                         emit_at_limit=False, chunks=1, eos=stop)
    assert emitted == free[:3]
