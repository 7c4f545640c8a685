"""Prefill block plan and the decode chunks.

Semantics are the JAX package's (runtime/decode_loop.py, and the serving
program runtime/batched.py::batched_decode_chunk_impl): each step emits the
current token, runs the forward at the current position, draws one xorshift
coin and samples the next token. A stream stops at BOS/EOS (the stop token
is not emitted) or when its position reaches its limit; its token, position
and RNG then freeze. Completion stops *before* emitting at the limit
(src/completion.c:57); chat emits the final token first (`emit_at_limit`,
src/completion.c:279-284).

Two chunk programs:
- `decode_chunk` (B = 1, the JAX package's fused chunk): the loop's state
  (token, position, RNG, stop flag, emitted ids) lives on the device, and
  the host queues a step count it knows from the position and the limit
  alone; steps after a stop run with their state frozen. Nothing is read
  back until the caller reads `packed`, once a chunk.
- `batched_decode_chunk` (the serving program, also the single-stream
  engine's "slot" and "side" programs at B = 1): the loop runs on the host,
  which reads each step's sampled ids to decide whether to go on. The step
  count, the KV rows written and the tokens are the JAX program's.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_tpu_torch.models.qwen3 import decode_forward, forward
from qwen3_tpu_torch.runtime.kvcache import make_side, split, tensors
from qwen3_tpu_torch.runtime.sampler import sample_tokens
from qwen3_tpu_torch.runtime.xorshift import (
    xorshift_coin_device,
    xorshift_float,
)
from qwen3_tpu_torch.utils.profiling import SPANS

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


def chunk_steps(pos: int, limit: int, chunk: int) -> int:
    """The steps decode_chunk runs from host position `pos`: the JAX
    while_loop's iterations for a stream that draws no stop token (one per
    token emitted, plus the one that meets the limit), at least one."""
    return min(chunk, max(1, limit - pos + 1))


def decode_chunk(params, cfg, k_cache, v_cache, token, pos, limit, rng_hi,
                 rng_lo, *, mode: str, chunk: int, temperature: float,
                 top_p: float, greedy: bool, bos: int, eos: int,
                 emit_at_limit: bool = False, top_k: int = 0,
                 attn: str = "dense", fuse: bool = False, group=None,
                 out_vocab: int | None = None):
    """Up to `chunk` decode steps of one stream (B = 1), the JAX package's
    decode_chunk.

    token: int [1] on the device, the current sampled-but-unemitted token.
    pos, limit: host ints (a 0-dim tensor is read once, before the first
    step): the next forward's position and the exclusive position bound.
    rng_hi, rng_lo: the xorshift64* state as 0-dim int64 device tensors
    (xorshift.to_device_state). temperature/top_p: clamped host floats.
    `attn` "dense" or "flash" (flash decode at T = 1); `fuse`, and `group`
    and `out_vocab` (tensor parallelism, parallel/tp.py), as in
    models.qwen3.forward.

    The host queues chunk_steps(pos, limit, chunk) steps and reads nothing
    back. Step i runs the forward at the position clamped into the cache
    (JAX's safe_pos) with `live` = pos + i + 1, the exact bound while the
    stream runs; once a stop token is drawn or the limit met, later steps
    keep token, position, RNG and the emitted ids as they were. Such a step
    may rewrite KV row `pos`, which nothing reads before the next prefill
    rewrites it; no row below the final position changes, except when the
    position reaches the cache's last row + 1, where the clamped write
    lands on that row, as in the JAX package.

    Returns (packed int32 [chunk + 2] = (tokens.. with -1 padding,
    n_emitted, done), k, v, token [1], pos, rng_hi, rng_lo), all on the
    device; pos equals min(pos + n_emitted, limit), so a caller that has
    read `packed` knows it without another read."""
    pos0, limit = int(pos), int(limit)
    dev = token.device
    rows = split(k_cache)[0].shape[2]
    tok = token.reshape(1).to(torch.int64)
    pos_t = torch.full((), pos0, dtype=torch.int64, device=dev)
    hi, lo = rng_hi, rng_lo
    done = torch.zeros((), dtype=torch.bool, device=dev)
    emitted = []
    for i in range(chunk_steps(pos0, limit, chunk)):
        is_stop = (tok[0] == bos) | (tok[0] == eos)
        at_limit = pos_t >= limit
        emit = ~done & ~is_stop
        if not emit_at_limit:
            emit = emit & ~at_limit
        emitted.append(torch.where(emit, tok[0], -1))
        done = done | is_stop | at_limit
        logits, k_cache, v_cache = forward(
            params, cfg, tok[None], k_cache, v_cache,
            pos_t.clamp(max=rows - 1), mode=mode, attn=attn,
            live=min(pos0 + i + 1, rows), fuse=fuse, group=group,
            out_vocab=out_vocab)
        nhi, nlo, coin = xorshift_coin_device(hi, lo)
        nxt = sample_tokens(logits[:, 0], coin.reshape(1), temperature,
                            top_p, greedy=greedy, top_k_hint=top_k)
        tok = torch.where(done, tok, nxt)
        pos_t = torch.where(done, pos_t, pos_t + 1)
        hi = torch.where(done, hi, nhi)
        lo = torch.where(done, lo, nlo)
    out = torch.stack(emitted)
    n_emitted = torch.sum(out >= 0)
    packed = torch.cat([
        out, torch.full((chunk - out.shape[0],), -1, dtype=out.dtype,
                        device=dev),
        n_emitted[None], done.to(out.dtype)[None]]).to(torch.int32)
    return packed, k_cache, v_cache, tok, pos_t, hi, lo


def decode_chunk_host(params, cfg, k_cache, v_cache, token: int, pos: int,
                      limit: int, rng: int, *, mode: str, chunk: int,
                      temperature: float, top_p: float, greedy: bool,
                      bos: int, eos: int, emit_at_limit: bool = False,
                      top_k: int = 0, attn: str = "dense",
                      fuse: bool = False):
    """decode_chunk's plain version: the JAX while_loop run one step at a
    time with a host read after each (token, position and RNG state host
    ints), ending where that loop ends. Its steps are decode_chunk's, so
    the two give the same packed ids, token, position and RNG state, and
    the same KV rows below the final position, bit for bit.

    Returns (packed np.int32 [chunk + 2], k, v, token, pos, rng)."""
    rows = split(k_cache)[0].shape[2]
    dev = params["emb_q"].device
    out, done = [], False
    while len(out) < chunk and not done:
        is_stop = token in (bos, eos)
        at_limit = pos >= limit
        if not is_stop and (emit_at_limit or not at_limit):
            out.append(token)
        done = is_stop or at_limit
        # the forward runs on the final step too, as in the JAX loop
        logits, k_cache, v_cache = forward(
            params, cfg, torch.tensor([[token]], device=dev), k_cache,
            v_cache, min(pos, rows - 1), mode=mode, attn=attn, fuse=fuse)
        state, coin = xorshift_float(rng)
        nxt = sample_tokens(logits[:, 0], torch.tensor([coin], device=dev),
                            temperature, top_p, greedy=greedy,
                            top_k_hint=top_k)
        if not done:
            token, pos, rng = int(nxt[0]), pos + 1, state
    packed = np.full(chunk + 2, -1, np.int32)
    packed[:len(out)] = out
    packed[-2:] = len(out), done
    return packed, k_cache, v_cache, token, pos, rng


def batched_decode_chunk(params, cfg, k_cache, v_cache, token, pos, limit,
                         done, rng, temp, topp, emit_lim, *, chunk: int,
                         greedy: bool, bos: int, eos: int, top_k: int = 0,
                         attn: str = "dense", mode: str = "pallas",
                         use_side: bool = False, bucket: int | None = None,
                         fuse: bool = False, group=None,
                         out_vocab: int | None = None, dp_group=None,
                         counts: dict | None = None):
    """Up to `chunk` decode steps over all live slots.

    token/pos/limit/done/rng/temp/topp/emit_lim: per-slot [B] host arrays
    (rng: xorshift64* states as python ints; temp/topp pre-clamped).
    `greedy=True` asserts every slot is greedy; otherwise rows at the
    epsilon temperature argmax individually.

    `use_side` (the serving engine's default): the chunk's K/V rows go to
    side buffers at a uniform step index while the main cache stays read
    only, and each slot's rows merge into the main cache at its chunk-start
    position after the loop (the cache needs `chunk` rows past the last
    position, which BatchedEngine allocates). `bucket`: the fused
    attention's rows (host-chosen, >= every slot's position). `fuse`: the
    prologue-fused matmuls (models.qwen3.forward). `group`/`out_vocab`:
    tensor parallelism, as in models.qwen3.forward.

    `dp_group` (data parallelism, parallel/tp.py::make_tp_batched_chunk):
    the host arrays stay whole [B] on every rank, the caches hold this
    rank's share of the slots, [index * b, (index + 1) * b) for the cache's
    b rows, and each step's sampled ids are all-gathered over the group
    before the host reads them, so every rank steps the same state.

    `counts` (the serving engine's, runtime/batched.py::COUNTS): each step
    adds its slots to "slot_steps_live" (not done when the step starts),
    "slot_steps_frozen" (done since earlier in the chunk) and
    "slot_steps_empty" (done when the chunk started: a slot with no
    request). Spans (utils/profiling.py::SPANS): `step` a step, inside it
    `step.enqueue` (until the sampler's launch returns) and `step.read` (the
    host read of the sampled ids); `chunk.merge` the side buffers' merge.

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
    bl, rows = split(k_cache)[0].shape[1:3]
    lo = 0 if dp_group is None else dp_group.index * bl
    mine = slice(lo, lo + bl)
    temp_t = torch.tensor(np.asarray(temp, np.float32)[mine], device=dev)
    topp_t = torch.tensor(np.asarray(topp, np.float32)[mine], device=dev)
    g = True if greedy else temp_t <= GREEDY_EPS
    out = np.full((B, chunk), -1, np.int32)
    if use_side:
        base_pos = pos.copy()        # frozen for the chunk
        base_t = torch.from_numpy(base_pos[mine]).to(dev)
        side_k, side_v = make_side(k_cache, chunk), make_side(v_cache, chunk)
    empty = int(np.count_nonzero(done))
    step = 0
    while step < chunk and not done.all():
        if counts is not None:
            n_done = int(np.count_nonzero(done))
            counts["slot_steps_live"] += B - n_done
            counts["slot_steps_frozen"] += n_done - empty
            counts["slot_steps_empty"] += empty
        sid = SPANS.begin("step")
        enqueue = SPANS.begin("step.enqueue")
        is_stop = (token == bos) | (token == eos)
        at_limit = pos >= limit
        newly_done = done | is_stop | at_limit
        emit = ~done & ~is_stop & (emit_lim | ~at_limit)
        out[:, step] = np.where(emit, token, -1)
        # the coins depend on no device data: upload them before the
        # forward is queued, so the upload does not wait for it
        draws = [xorshift_float(s) for s in rng]
        coin = torch.tensor([c for _, c in draws[mine]], dtype=torch.float32,
                            device=dev)
        tok_t = torch.from_numpy(token[mine]).to(dev)
        if use_side:
            logits, side_k, side_v = decode_forward(
                params, cfg, tok_t, k_cache, v_cache,
                torch.from_numpy(pos[mine]).to(dev), mode=mode, attn=attn,
                side=(side_k, side_v, base_t, step),
                live=int(base_pos.max()), attn_bucket=bucket, fuse=fuse,
                group=group, out_vocab=out_vocab)
        else:
            # done slots still run (their rows are wasted work); their
            # write position is clamped into the cache
            write_pos = np.minimum(pos, rows - 1)
            logits, k_cache, v_cache = decode_forward(
                params, cfg, tok_t, k_cache, v_cache,
                torch.from_numpy(write_pos[mine]).to(dev), mode=mode,
                attn=attn, live=int(write_pos.max()) + 1, fuse=fuse,
                group=group, out_vocab=out_vocab)
        nxt = sample_tokens(logits, coin, temp_t, topp_t, greedy=g,
                            top_k_hint=top_k)
        SPANS.end(enqueue)
        if dp_group is not None:
            nxt = dp_group.cat(nxt, 0)
        read = SPANS.begin("step.read")
        nxt = nxt.cpu().numpy()
        SPANS.end(read)
        live = ~newly_done
        token = np.where(live, nxt, token)
        pos = np.where(live, pos + 1, pos)
        rng = [st if ok else old for (st, _), old, ok in zip(draws, rng, live)]
        done = newly_done
        step += 1
        SPANS.end(sid)
    if use_side:
        # each slot's chunk window into the main cache at its chunk-start
        # position, once per chunk; rows past its final position carry
        # garbage that nothing reads before it is rewritten
        sid = SPANS.begin("chunk.merge")
        for main, buf in ((k_cache, side_k), (v_cache, side_v)):
            for m, sb in zip(tensors(main), tensors(buf)):
                for j in range(bl):
                    at = base_pos[lo + j]
                    m[:, j, at:at + chunk] = sb[:, j]
        SPANS.end(sid)
    packed = np.concatenate(
        [out, pos[:, None].astype(np.int32), done[:, None].astype(np.int32)],
        axis=1)
    return packed, k_cache, v_cache, token, pos, done, rng
