"""Continuous-batching serving engine (qwen3_tpu/runtime/batched.py's
contract, on the port).

The reference serves exactly one stream, one token per forward
(src/completion.c:57-80); this engine serves up to `max_batch` concurrent
streams through one shared [L, B, S, KV, HD] KV cache:

- each slot carries its own position, stop state and xorshift64* RNG state
  (per-request seeds stay reproducible regardless of batch composition;
  done slots keep their RNG frozen);
- decode runs in chunks over all slots (per-slot positions, per-slot causal
  masks), `decode_chunk` steps per chunk, the chunk's K/V rows staged in a
  side buffer and merged into the cache once per chunk
  (runtime/decode_loop.py::batched_decode_chunk);
- new requests are admitted between chunks by prefilling into a free slot's
  cache rows, fresh prompts with the same block plan in one [N, C] forward
  (continuous batching at chunk granularity).

Token streams do not depend on batch-mates: the only interaction between
slots is batching of identical per-row math. On the card the matmul kernels
and the attention kernels compute every row the same way at any batch size
(csrc/q8_matmul.cu, csrc/batched_decode.cu).

The JAX package compiles each chunk into one device program; here the host
runs the loop and queues each step's kernels. `tp`/`dp` > 1 (the mesh
programs) and `aot_dir` (the TPU's compiled-executable cache) are not
ported yet and raise. The env-gated QWEN3_TPU_STATIC_BUCKET probe of the
JAX engine is not ported: the port's dense attention always reads the live
prefix, and the fused attention always takes a host-chosen bucket.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.models.qwen3 import (
    check_mode,
    forward,
    init_kv_cache,
    load_params,
    resolve_device,
)
from qwen3_tpu_torch.runtime import kvcache
from qwen3_tpu_torch.runtime.decode_loop import (
    GREEDY_EPS,
    batched_decode_chunk,
    burn_and_sample,
    prefill_blocks,
    prefill_plan,
)
from qwen3_tpu_torch.runtime.sampler import (
    clamp_temperature,
    clamp_top_p,
    sample_tokens,
)
from qwen3_tpu_torch.runtime.xorshift import xorshift_float
from qwen3_tpu_torch.tokenizer import Tokenizer

_M64 = (1 << 64) - 1
# batched admission's caps: rows (N x block width) per [N, C] forward, whose
# activations scale with N * C, and the bytes of the slot rows one gathered
# admission copies (the JAX engine's defaults; its environment knobs for
# them are not ported)
ADMIT_ROWS = 1024
ADMIT_KV_BYTES = 1536 << 20


def bucket_sizes(s: int, smallest: int = 256) -> list[int]:
    """Power-of-two prefix lengths up to S, always including S
    (qwen3_tpu/ops/attention.py::_bucket_sizes)."""
    sizes = []
    b = smallest
    while b < s:
        sizes.append(b)
        b *= 2
    sizes.append(s)
    return sizes


def _slot_rows(cache, slots: list[int]):
    """The cache's rows of `slots` ([L, N, ...] per tensor): a view when the
    slots are consecutive (writes land in the cache), else a gathered copy
    (put back by _put_rows)."""
    vals, sc = kvcache.split(cache)
    s0 = slots[0]
    if slots == list(range(s0, s0 + len(slots))):
        take = (lambda t: t[:, s0:s0 + len(slots)])
    else:
        idx = torch.tensor(slots, device=vals.device)
        take = (lambda t: t[:, idx])
    return kvcache.join(take(vals), None if sc is None else take(sc))


def _put_rows(cache, rows, slots: list[int]) -> None:
    """Scatter gathered slot rows back (a no-op for _slot_rows' views)."""
    for full, part in zip(kvcache.tensors(cache), kvcache.tensors(rows)):
        if part.data_ptr() != full[:, slots[0]].data_ptr():
            full[:, slots] = part


def prefill_slot_chunk(params, cfg, k_cache, v_cache, tokens: list[int],
                       slot: int, start_pos: int, last_pos: int, *,
                       mode: str, fuse: bool = False):
    """One prompt chunk into cache slot `slot`: the same [1, T] forward the
    single-stream engine's prefill dispatches, on the slot's rows in place.
    tokens: [T] padded per decode_loop.prefill_blocks (padded rows only
    write cache rows the decode loop overwrites before reading). Returns
    (last-valid-position logits [V], k, v)."""
    kr, vr = _slot_rows(k_cache, [slot]), _slot_rows(v_cache, [slot])
    dev = params["emb_q"].device
    logits, kr, vr = forward(params, cfg,
                             torch.tensor([tokens], device=dev), kr, vr,
                             start_pos, mode=mode, last_pos=last_pos,
                             fuse=fuse)
    _put_rows(k_cache, kr, [slot])
    _put_rows(v_cache, vr, [slot])
    return logits[0, 0], k_cache, v_cache


def prefill_slots_chunk(params, cfg, k_cache, v_cache,
                        tokens: list[list[int]], slots: list[int],
                        start_pos: int, last_pos: list[int], *, mode: str,
                        fuse: bool = False):
    """One prompt chunk for N requests at once: one [N, C] forward over the
    N slots' rows (a view when the slots are consecutive, else gathered and
    scattered back). Per-row math does not depend on the batch size, so each
    stream equals its serial admission. tokens: [N][C] padded blocks;
    start_pos: the shared block start (batched admission serves fresh
    start_pos=0 requests); last_pos: per-row last valid index in the block.
    Returns (logits [N, V], k, v)."""
    kr, vr = _slot_rows(k_cache, slots), _slot_rows(v_cache, slots)
    dev = params["emb_q"].device
    logits, kr, vr = forward(params, cfg, torch.tensor(tokens, device=dev),
                             kr, vr, start_pos, mode=mode,
                             last_pos=torch.tensor(last_pos, device=dev),
                             fuse=fuse)
    _put_rows(k_cache, kr, slots)
    _put_rows(v_cache, vr, slots)
    return logits[:, 0], k_cache, v_cache


def first_tokens_batch(logits: torch.Tensor, rng: list[int], temp, topp, *,
                       top_k: int):
    """First sampled token for N freshly prefilled requests (the batched
    counterpart of decode_loop.burn_and_sample at n_burn=0; per-row math is
    identical, so streams equal serial admission). logits [N, V]; rng: N
    xorshift states; temp/topp: N clamped floats. Returns (tokens [N] host
    ints, new rng states)."""
    draws = [xorshift_float(s) for s in rng]
    dev = logits.device
    coin = torch.tensor([c for _, c in draws], dtype=torch.float32,
                        device=dev)
    temp_t = torch.tensor(np.asarray(temp, np.float32), device=dev)
    topp_t = torch.tensor(np.asarray(topp, np.float32), device=dev)
    tok = sample_tokens(logits, coin, temp_t, topp_t,
                        greedy=temp_t <= GREEDY_EPS, top_k_hint=top_k)
    return [int(t) for t in tok.cpu()], [s for s, _ in draws]


@dataclasses.dataclass
class Request:
    prompt: str | bytes
    seed: int = 0
    max_tokens: Optional[int] = None
    stream_cb: Optional[Callable[[bytes], None]] = None
    # per-request sampler overrides (None = engine defaults); clamped with
    # the reference's sampler_create semantics (src/sampler.c:36-52)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # chat-turn plumbing (used by BatchedChat; completion requests leave
    # these at their defaults):
    slot: Optional[int] = None      # pinned slot (conversation KV residency)
    start_pos: int = 0              # cache position of the turn's first id
    rng: Optional[int] = None       # xorshift64* state to continue
    burn_prompt: bool = False       # burn len(ids)-1 draws (chat RNG parity)
    emit_at_limit: bool = False     # emit the token sampled at the limit
    # filled by the engine:
    rid: int = -1
    prompt_ids: list = dataclasses.field(default_factory=list)
    out_ids: list = dataclasses.field(default_factory=list)
    finished: bool = False
    prompt_ms: float = 0.0      # pp: encode + prefill wall ms
    generate_ms: float = 0.0    # tg: admit-to-finish decode wall ms
    end_pos: int = 0            # slot position after the turn (chat)
    end_rng: Optional[int] = None     # xorshift state after the turn (chat)
    _t_admit: float = 0.0

    @property
    def ms_per_token(self) -> float:
        return self.generate_ms / max(len(self.out_ids), 1)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None


class BatchedEngine:
    """Continuous-batching server over a fixed slot pool."""

    def __init__(self, path: str, *, max_batch: int = 8, seq_len: int = 1024,
                 mode: str = "pallas-fast", temperature: float = 1.0,
                 top_p: float = 0.9, kv_dtype: str = "float32",
                 prefill_bucket: int = 128, decode_chunk: int = 32,
                 top_k: int = 64, attn: str = "auto",
                 side_buffer: bool = True, tp: int = 1, dp: int = 1,
                 model_cfg: ModelConfig | None = None, params=None,
                 aot_dir: str | None = None, device="cuda",
                 fuse: bool = False, native_tokenizer: bool = True):
        """`model_cfg`/`params` inject parameters already on the device,
        skipping the checkpoint load; `path` is then only read for the
        `.tokenizer` sidecar. `device` is "cuda" (the default; without a
        card it raises) or "cpu" (the kernels' plain versions). `fuse`: the
        prologue-fused matmuls in modes pallas and pallas-fast (ignored in
        the others). `native_tokenizer`: encode through the native C++
        core."""
        check_mode(mode)
        if tp > 1 or dp > 1:
            raise NotImplementedError("tp/dp > 1 serving is not ported yet")
        if aot_dir is not None:
            raise NotImplementedError(
                "aot_dir (the TPU's compiled-executable cache) is not ported")
        if attn not in ("auto", "dense", "flash", "fused"):
            raise NotImplementedError(f"attn={attn!r} is not ported yet")
        self.device = resolve_device(device)
        self.tokenizer = Tokenizer.from_file(path, native_tokenizer)
        if params is not None:
            if model_cfg is None:
                raise ValueError("params injection needs model_cfg")
            mc, self.params = model_cfg, params
        else:
            mc, self.params = load_params(path, mode=mode,
                                          max_seq_len=seq_len,
                                          device=self.device)
        self.cfg: ModelConfig = mc.with_seq_len(seq_len)
        self.mode = mode
        self.fuse = fuse
        if attn == "auto":
            # the JAX engine's rule: flash only single-stream at long
            # context, else the fused batched kernel on the side buffer
            attn = ("flash" if max_batch == 1 and seq_len >= 8192
                    else "fused" if side_buffer else "dense")
        if attn == "fused" and not side_buffer:
            raise ValueError("attn='fused' runs over the side buffer: "
                             "leave side_buffer on")
        self.attn = attn
        self.side_buffer = side_buffer
        self.max_batch = max_batch
        self.temperature = clamp_temperature(temperature)
        self.top_p = clamp_top_p(top_p)
        self.greedy = self.temperature <= GREEDY_EPS
        self.prefill_bucket = prefill_bucket
        self.decode_chunk = decode_chunk
        self.top_k = top_k

        B = max_batch
        # the side buffer merges a full chunk window per slot; the extra rows
        # absorb the overhang of a slot finishing right at seq_len. Dense and
        # fused pad to 128 rows, flash to its 256-row tile
        cache_rows = kvcache.pad_rows(
            self.cfg.seq_len + (decode_chunk if side_buffer else 0),
            quantum=128 if self.attn in ("dense", "fused") else 256)
        self._kv = init_kv_cache(self.cfg, B, cache_rows, kv_dtype,
                                 self.device)
        # per-slot sampler params (engine defaults until a request
        # overrides), and the slots' state, all on the host
        self._temp = np.full((B,), self.temperature, np.float32)
        self._topp = np.full((B,), self.top_p, np.float32)
        self._emit = np.zeros((B,), np.bool_)
        self._pinned: set[int] = set()   # conversation-held slots
        self._token = np.zeros((B,), np.int64)
        self._pos = np.zeros((B,), np.int64)
        self._limit = np.zeros((B,), np.int64)
        self._done = np.ones((B,), np.bool_)
        self._rng = [0] * B
        # fused: the host picks the attention bucket per chunk, the
        # smallest power-of-two prefix covering every slot's rows
        self._attn_buckets = (bucket_sizes(cache_rows)
                              if self.attn == "fused" else None)
        self._slots = [_Slot() for _ in range(B)]
        self._queue: list[Request] = []
        self._next_rid = 0

    # -- API -------------------------------------------------------------

    def submit(self, req: Request) -> Request:
        req.rid = self._next_rid
        self._next_rid += 1
        self._queue.append(req)
        return req

    def run(self) -> list[Request]:
        """Run until every submitted request finishes; returns them."""
        finished: list[Request] = []
        while self._queue or any(s.req for s in self._slots):
            self._admit()
            if self._queue and not any(s.req for s in self._slots):
                # nothing admitted and nothing live: every remaining request
                # needs a slot that conversations hold pinned; spinning
                # would livelock (pins only drop via BatchedChat.close)
                raise RuntimeError(
                    f"{len(self._queue)} queued request(s) cannot be "
                    f"admitted: all free slots are pinned by conversations "
                    f"({sorted(self._pinned)}); close a conversation or "
                    f"raise max_batch")
            finished.extend(self._step())
        return finished

    # -- internals ---------------------------------------------------------

    def _sampler_of(self, b: int, req: Request) -> tuple[float, float]:
        r_temp = (self.temperature if req.temperature is None
                  else clamp_temperature(req.temperature))
        r_topp = (self.top_p if req.top_p is None
                  else clamp_top_p(req.top_p))
        self._temp[b] = r_temp
        self._topp[b] = r_topp
        self._emit[b] = req.emit_at_limit
        return r_temp, r_topp

    def _start(self, b: int, req: Request, token: int, pos: int,
               rng: int) -> None:
        """Slot b begins decoding `req` at `pos` with its first token."""
        self._token[b] = token
        self._pos[b] = pos
        limit = self.cfg.seq_len
        if req.max_tokens is not None:
            limit = min(limit, pos + req.max_tokens)
        self._limit[b] = limit
        self._done[b] = False
        self._rng[b] = rng
        self._slots[b].req = req

    def _admit(self) -> None:
        # chat turns go to their pinned slot; fresh requests fill free,
        # unpinned slots in FIFO order
        for req in [r for r in self._queue if r.slot is not None]:
            if self._slots[req.slot].req is None:
                self._queue.remove(req)
                self._admit_into(req.slot, req)
        assigned: list[tuple[int, Request]] = []
        for b, slot in enumerate(self._slots):
            if slot.req is not None or b in self._pinned:
                continue
            req = next((r for r in self._queue if r.slot is None), None)
            if req is None:
                break
            self._queue.remove(req)
            assigned.append((b, req))

        # batched admission: fresh prompts with the same block plan prefill
        # in ONE [N, C] forward per block; chat continuations (start_pos,
        # rng, burn) take the serial path
        C = self.prefill_bucket
        groups: dict[tuple, list[tuple[int, Request, list]]] = {}
        for b, req in assigned:
            ids = self.tokenizer.encode(req.prompt)[: self.cfg.seq_len]
            if (not req.burn_prompt
                    and req.rng is None and req.start_pos == 0 and ids):
                plan = prefill_plan(len(ids), 0, C, self.cfg.seq_len)
                groups.setdefault(plan, []).append((b, req, ids))
            else:
                self._admit_into(b, req)
        for plan, items in groups.items():
            # cap N by ADMIT_ROWS and ADMIT_KV_BYTES
            widest = max(size for _, size in plan)
            cap_n = max(2, ADMIT_ROWS // max(widest, 1))
            per_row = (sum(t.numel() * t.element_size()
                           for side in self._kv for t in kvcache.tensors(side))
                       // max(self.max_batch, 1))
            cap_n = max(1, min(cap_n, ADMIT_KV_BYTES // max(2 * per_row, 1)))
            while len(items) > 1:
                part, items = items[:cap_n], items[cap_n:]
                if len(part) == 1:
                    self._admit_into(part[0][0], part[0][1])
                else:
                    self._admit_batch(part, plan)
            if items:
                self._admit_into(items[0][0], items[0][1])

    def _admit_batch(self, items: list, plan: tuple) -> None:
        t0 = time.perf_counter()
        temps, topps = [], []
        for b, req, ids in items:
            r_temp, r_topp = self._sampler_of(b, req)
            req.prompt_ids = ids
            temps.append(r_temp)
            topps.append(r_topp)
        slots = [b for b, _, _ in items]
        k, v = self._kv
        logits = None
        for off, size in plan:
            blocks, lasts = [], []
            for _, _, ids in items:
                blk = ids[off:off + size]
                lasts.append(len(blk) - 1)
                blocks.append(blk + [0] * (size - len(blk)))
            logits, k, v = prefill_slots_chunk(self.params, self.cfg, k, v,
                                               blocks, slots, off, lasts,
                                               mode=self.mode, fuse=self.fuse)
        self._kv = (k, v)
        seeds = [req.seed & _M64 for _, req, _ in items]
        toks, rngs = first_tokens_batch(logits, seeds, temps, topps,
                                        top_k=self.top_k)
        now = time.perf_counter()
        for (b, req, ids), tok, rng in zip(items, toks, rngs):
            req.prompt_ms = (now - t0) * 1e3
            req._t_admit = now
            self._start(b, req, tok, len(ids), rng)

    def _admit_into(self, b: int, req: Request) -> None:
        t0 = time.perf_counter()
        ids = self.tokenizer.encode(req.prompt)
        # never run past the context (reference chat clips the same way)
        ids = ids[: self.cfg.seq_len - req.start_pos]
        if not ids:
            req.finished = True
            return
        r_temp, r_topp = self._sampler_of(b, req)
        req.prompt_ids = ids

        # chunked prefill with the same block plan as Engine._prefill
        k, v = self._kv
        logits = None
        for off, block, n_valid in prefill_blocks(
                ids, req.start_pos, self.prefill_bucket, self.cfg.seq_len):
            logits, k, v = prefill_slot_chunk(
                self.params, self.cfg, k, v, block, b, req.start_pos + off,
                n_valid - 1, mode=self.mode, fuse=self.fuse)
        self._kv = (k, v)

        rng = req.seed & _M64 if req.rng is None else req.rng
        n_burn = len(ids) - 1 if req.burn_prompt else 0
        tok, rng = burn_and_sample(logits, rng, n_burn, r_temp, r_topp,
                                   greedy=r_temp <= GREEDY_EPS,
                                   top_k=self.top_k)
        req.prompt_ms = (time.perf_counter() - t0) * 1e3
        req._t_admit = time.perf_counter()
        self._start(b, req, tok, req.start_pos + len(ids), rng)

    def _bucket(self) -> Optional[int]:
        """The fused attention's rows for the next chunk: two-segment
        attention reads main rows < base_pos (the chunk's rows live in the
        side buffer), so the largest slot position must fit."""
        if self._attn_buckets is None:
            return None
        need = int(self._pos.max())
        return next((n for n in self._attn_buckets if n >= need),
                    self._attn_buckets[-1])

    def _step(self) -> list[Request]:
        """One batched decode chunk; returns requests finished this chunk."""
        if not any(s.req for s in self._slots):
            return []
        all_greedy = bool((self._temp <= GREEDY_EPS).all())
        k, v = self._kv
        packed, k, v, tok, pos, done, rng = batched_decode_chunk(
            self.params, self.cfg, k, v, self._token, self._pos,
            self._limit, self._done, self._rng, self._temp, self._topp,
            self._emit, chunk=self.decode_chunk, greedy=all_greedy,
            bos=self.tokenizer.special.bos, eos=self.tokenizer.special.eos,
            top_k=self.top_k, attn=self.attn, mode=self.mode,
            use_side=self.side_buffer, bucket=self._bucket(), fuse=self.fuse)
        self._kv = (k, v)
        self._token, self._pos, self._done, self._rng = tok, pos, done, rng
        finished = []
        for b, slot in enumerate(self._slots):
            req = slot.req
            if req is None:
                continue
            toks = [int(t) for t in packed[b, :self.decode_chunk] if t >= 0]
            if toks:
                req.out_ids.extend(toks)
                if req.stream_cb:
                    req.stream_cb(self.tokenizer.decode(toks))
            if bool(packed[b, -1]):
                req.finished = True
                req.generate_ms = (time.perf_counter() - req._t_admit) * 1e3
                if req.slot is not None:
                    # conversation bookkeeping for the next turn
                    req.end_pos = int(packed[b, -2])
                    req.end_rng = self._rng[b]
                finished.append(req)
                slot.req = None
                # freed slots fall back to engine defaults so an all-greedy
                # batch recovers the argmax-only path
                self._temp[b] = self.temperature
                self._topp[b] = self.top_p
                self._emit[b] = False
        return finished

    # -- conversation slot pinning (used by BatchedChat) -------------------

    def pin_slot(self) -> int:
        """Reserve a free slot for a conversation's KV residency."""
        for b, slot in enumerate(self._slots):
            if slot.req is None and b not in self._pinned:
                self._pinned.add(b)
                return b
        raise RuntimeError("no free slot to pin (all held by conversations)")

    def unpin_slot(self, b: int) -> None:
        self._pinned.discard(b)
