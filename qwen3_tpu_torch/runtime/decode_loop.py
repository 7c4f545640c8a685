"""Prefill block plan and the decode chunk.

Semantics are the JAX package's (runtime/decode_loop.py, and the serving
program runtime/batched.py::batched_decode_chunk_impl without side buffers,
which the single-stream engine runs at B=1): each step emits the current
token, runs the forward at the current position, draws one xorshift coin and
samples the next token. A slot stops at BOS/EOS (the stop token is not
emitted) or when its position reaches its limit; its token, position and RNG
then freeze. Completion stops *before* emitting at the limit
(src/completion.c:57); chat emits the final token first (`emit_lim`,
src/completion.c:279-284).

The JAX package runs the chunk inside one jitted while_loop; here the loop
runs on the host, PyTorch queues each step's forward on the device, and one
small read of the sampled ids per step decides whether to go on. The step
count, the KV rows written and the tokens are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_tpu_torch.models.qwen3 import decode_forward
from qwen3_tpu_torch.runtime.kvcache import split
from qwen3_tpu_torch.runtime.sampler import sample_tokens
from qwen3_tpu_torch.runtime.xorshift import xorshift_float

GREEDY_EPS = 1e-6


# Graduated block sizes for long prompts, largest first: the bulk of a long
# prompt runs in the widest block that fits, the tail in the configured chunk
PREFILL_LADDER = (512, 256, 128)


def prefill_plan(n: int, start_pos: int, chunk: int,
                 seq_len: int) -> tuple[tuple[int, int], ...]:
    """The prompt-chunking policy as a shape plan: ((offset, width), ...) for
    an n-token prompt starting at start_pos. Widths come from the graded
    ladder when the remaining prompt fills them, else `chunk`. A block never
    extends past the cache."""
    n = min(n, seq_len - start_pos)
    plan: list[tuple[int, int]] = []
    off = 0
    while off < n:
        rem = n - off
        cap = seq_len - (start_pos + off)
        size = chunk
        for s in PREFILL_LADDER:
            if s > chunk and rem >= s and cap >= s:
                size = s
                break
        plan.append((off, min(size, cap)))
        off += size
    return tuple(plan)


def prefill_blocks(ids: list, start_pos: int, chunk: int, seq_len: int):
    """prefill_plan applied to concrete ids: yields (offset, padded_block,
    n_valid) per block."""
    ids = ids[: seq_len - start_pos]
    for off, size in prefill_plan(len(ids), start_pos, chunk, seq_len):
        block = ids[off:off + size]
        yield off, block + [0] * (size - len(block)), len(block)


def burn_and_sample(logits: torch.Tensor, rng_state: int, n_burn: int,
                    temperature: float, top_p: float, *, greedy: bool,
                    top_k: int = 0) -> tuple[int, int]:
    """Advance the RNG `n_burn` draws (the reference chat loop burns one draw
    per prompt token, src/completion.c:318-323), then draw once and sample
    the first token from the prefill logits [V]. Returns (token, state)."""
    for _ in range(n_burn):
        rng_state, _ = xorshift_float(rng_state)
    rng_state, coin = xorshift_float(rng_state)
    g = greedy or temperature <= GREEDY_EPS
    coin_t = torch.tensor([coin], dtype=torch.float32, device=logits.device)
    tok = sample_tokens(logits[None, :], coin_t, temperature, top_p,
                        greedy=g, top_k_hint=top_k)
    return int(tok[0]), rng_state


def batched_decode_chunk(params, cfg, k_cache, v_cache, token, pos, limit,
                         done, rng, temp, topp, emit_lim, *, chunk: int,
                         greedy: bool, bos: int, eos: int, top_k: int = 0,
                         attn: str = "dense"):
    """Up to `chunk` decode steps over all live slots.

    token/pos/limit/done/rng/temp/topp/emit_lim: per-slot [B] host arrays
    (rng: xorshift64* states as python ints; temp/topp pre-clamped).
    `greedy=True` asserts every slot is greedy; otherwise rows at the
    epsilon temperature argmax individually.

    Returns (packed int32 [B, chunk + 2] = (tokens.., pos, done) with -1
    padding, k, v, token, pos, done, rng)."""
    token = np.array(token, dtype=np.int64)
    pos = np.array(pos, dtype=np.int64)
    limit = np.array(limit, dtype=np.int64)
    done = np.array(done, dtype=bool)
    emit_lim = np.array(emit_lim, dtype=bool)
    rng = list(rng)
    B = token.shape[0]
    dev = params["emb_q"].device
    rows = split(k_cache)[0].shape[2]
    temp_t = torch.tensor(np.asarray(temp, np.float32), device=dev)
    topp_t = torch.tensor(np.asarray(topp, np.float32), device=dev)
    g = True if greedy else temp_t <= GREEDY_EPS
    out = np.full((B, chunk), -1, np.int32)
    step = 0
    while step < chunk and not done.all():
        is_stop = (token == bos) | (token == eos)
        at_limit = pos >= limit
        newly_done = done | is_stop | at_limit
        emit = ~done & ~is_stop & (emit_lim | ~at_limit)
        out[:, step] = np.where(emit, token, -1)
        # done slots still run (their rows are wasted work); their write
        # position is clamped into the cache
        write_pos = np.minimum(pos, rows - 1)
        # the coins depend on no device data: upload them before the
        # forward is queued, so the upload does not wait for it
        draws = [xorshift_float(s) for s in rng]
        coin = torch.tensor([c for _, c in draws], dtype=torch.float32,
                            device=dev)
        logits, k_cache, v_cache = decode_forward(
            params, cfg, torch.from_numpy(token).to(dev), k_cache, v_cache,
            torch.from_numpy(write_pos).to(dev), attn=attn,
            live=int(write_pos.max()) + 1)
        nxt = sample_tokens(logits, coin, temp_t, topp_t, greedy=g,
                            top_k_hint=top_k).cpu().numpy()
        live = ~newly_done
        token = np.where(live, nxt, token)
        pos = np.where(live, pos + 1, pos)
        rng = [st if ok else old for (st, _), old, ok in zip(draws, rng, live)]
        done = newly_done
        step += 1
    packed = np.concatenate(
        [out, pos[:, None].astype(np.int32), done[:, None].astype(np.int32)],
        axis=1)
    return packed, k_cache, v_cache, token, pos, done, rng
