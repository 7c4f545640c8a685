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
(csrc/q8_matmul.cu, csrc/batched_decode.cu). The sampler's softmax sum is a
PyTorch reduction whose order on the card follows the number of rows, so a
seeded (not a greedy) stream can change with the slot count: a dp rank
samples its own share of the slots (ROADMAP Queue C #7).

The JAX package compiles each chunk into one device program; here the host
runs the loop and queues each step's kernels. `tp`/`dp` > 1 serves on a (dp,
tp) mesh of ranks (parallel/tp.py's programs): one process a rank, each
running this same host scheduler on the same requests. `aot_dir` (the TPU's
compiled-executable cache) is not ported and raises. The env-gated
QWEN3_TPU_STATIC_BUCKET probe of the JAX engine is not ported: the port's
dense attention always reads the live prefix, and the fused attention always
takes a host-chosen bucket.
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
from qwen3_tpu_torch.parallel.shard_layout import local_config
from qwen3_tpu_torch.parallel.sharding import make_mesh
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
from qwen3_tpu_torch.utils.profiling import SPANS

_M64 = (1 << 64) - 1
# batched admission's caps: rows (N x block width) per [N, C] forward, whose
# activations scale with N * C, and the bytes of the slot rows one gathered
# admission copies (the JAX engine's defaults; its environment knobs for
# them are not ported)
ADMIT_ROWS = 1024
ADMIT_KV_BYTES = 1536 << 20

# the engine's work as the host counts it, always on (host integer adds):
# prefill forwards, the rows they compute (block widths, padding and the
# mesh's padding rows included) and the prompt tokens among them; admission
# groups (a batched group or a serial admission each) and the requests
# admitted; and every decode step's slots: live (running a request),
# frozen (running a request that finished earlier in the chunk) or empty.
# The slot counts add up to decode steps x max_batch.
COUNTS = {"prefill_forwards": 0, "prefill_rows": 0, "prefill_valid_rows": 0,
          "admit_groups": 0, "admitted": 0, "slot_steps_live": 0,
          "slot_steps_frozen": 0, "slot_steps_empty": 0}


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
    s0 = slots[0]
    if slots != list(range(s0, s0 + len(slots))):
        return _gather_rows(cache, slots)
    vals, sc = kvcache.split(cache)
    take = (lambda t: t[:, s0:s0 + len(slots)])
    return kvcache.join(take(vals), None if sc is None else take(sc))


def _gather_rows(cache, slots: list[int]):
    """A gathered copy of the cache's rows of `slots`, never a view."""
    vals, sc = kvcache.split(cache)
    idx = torch.tensor(slots, device=vals.device)
    return kvcache.join(vals[:, idx], None if sc is None else sc[:, idx])


def _put_rows(cache, rows, slots: list[int], valid=None) -> None:
    """Scatter gathered slot rows back (a no-op for _slot_rows' views);
    with `valid`, only the valid rows (their copy must be gathered)."""
    keep = None if valid is None else [i for i, ok in enumerate(valid) if ok]
    for full, part in zip(kvcache.tensors(cache), kvcache.tensors(rows)):
        if keep is not None:
            full[:, [slots[i] for i in keep]] = part[:, keep]
        elif part.data_ptr() != full[:, slots[0]].data_ptr():
            full[:, slots] = part


def prefill_slot_chunk(params, cfg, k_cache, v_cache, tokens: list[int],
                       slot: int, start_pos: int, last_pos: int, *,
                       mode: str, fuse: bool = False, group=None,
                       out_vocab: int | None = None):
    """One prompt chunk into cache slot `slot`: the same [1, T] forward the
    single-stream engine's prefill dispatches, on the slot's rows in place.
    tokens: [T] padded per decode_loop.prefill_blocks (padded rows only
    write cache rows the decode loop overwrites before reading). `group`/
    `out_vocab`: tensor parallelism (models.qwen3.forward). Returns
    (last-valid-position logits [V], k, v)."""
    kr, vr = _slot_rows(k_cache, [slot]), _slot_rows(v_cache, [slot])
    dev = params["emb_q"].device
    logits, kr, vr = forward(params, cfg,
                             torch.tensor([tokens], device=dev), kr, vr,
                             start_pos, mode=mode, last_pos=last_pos,
                             fuse=fuse, group=group, out_vocab=out_vocab)
    _put_rows(k_cache, kr, [slot])
    _put_rows(v_cache, vr, [slot])
    return logits[0, 0], k_cache, v_cache


def prefill_slots_chunk(params, cfg, k_cache, v_cache,
                        tokens: list[list[int]], slots: list[int],
                        start_pos: int, last_pos: list[int], *, mode: str,
                        fuse: bool = False, valid: list[bool] | None = None,
                        group=None, out_vocab: int | None = None):
    """One prompt chunk for N requests at once: one [N, C] forward over the
    N slots' rows (a view when the slots are consecutive, else gathered and
    scattered back). Per-row math does not depend on the batch size, so each
    stream equals its serial admission. tokens: [N][C] padded blocks;
    start_pos: the shared block start (batched admission serves fresh
    start_pos=0 requests); last_pos: per-row last valid index in the block.
    `valid` (the mesh's padding rows, parallel/tp.py): the rows' copies are
    gathered and only the valid rows' cache writes are kept. `group`/
    `out_vocab`: tensor parallelism (models.qwen3.forward). Returns
    (logits [N, V], k, v)."""
    if valid is None:
        kr, vr = _slot_rows(k_cache, slots), _slot_rows(v_cache, slots)
    else:
        kr, vr = _gather_rows(k_cache, slots), _gather_rows(v_cache, slots)
    dev = params["emb_q"].device
    logits, kr, vr = forward(params, cfg, torch.tensor(tokens, device=dev),
                             kr, vr, start_pos, mode=mode,
                             last_pos=torch.tensor(last_pos, device=dev),
                             fuse=fuse, group=group, out_vocab=out_vocab)
    _put_rows(k_cache, kr, slots, valid)
    _put_rows(v_cache, vr, slots, valid)
    return logits[:, 0], k_cache, v_cache


def _slots_of(cache) -> int:
    """The cache slots this rank holds (its dp share of the batch)."""
    return kvcache.split(cache)[0].shape[1]


def mesh_prefill_slot_chunk(mesh, params, cfg, k_cache, v_cache,
                            tokens: list[int], slot: int, start_pos: int,
                            last_pos: int, *, mode: str, fuse: bool = False,
                            out_vocab: int):
    """prefill_slot_chunk on a (dp, tp) mesh (parallel/sharding.py::Mesh;
    `cfg` the shard's dims, `slot` global). Each dp shard holds B/dp slots
    and the owner of `slot` is slot // (B/dp): only the owner's tp group
    runs the forward and writes its cache rows (a continuation chunk reads
    rows only the owner holds); the owner's logits are then broadcast over
    dp, so that no other shard's values can reach them. At dp = 1 this is
    prefill_slot_chunk over the tp group."""
    owner, local = divmod(slot, _slots_of(k_cache))
    if mesh.dp_idx == owner:
        logits, k_cache, v_cache = prefill_slot_chunk(
            params, cfg, k_cache, v_cache, tokens, local, start_pos,
            last_pos, mode=mode, fuse=fuse, group=mesh.tp_group,
            out_vocab=out_vocab)
    else:
        logits = torch.empty(out_vocab, dtype=torch.float32,
                             device=params["emb_q"].device)
    if mesh.dp_group is not None:
        logits = mesh.dp_group.broadcast(logits, owner)
    return logits, k_cache, v_cache


def mesh_prefill_slots_chunk(mesh, params, cfg, k_cache, v_cache,
                             tokens: list[list[int]], slots: list[int],
                             valid: list[bool], start_pos: int,
                             last_pos: list[int], *, mode: str,
                             fuse: bool = False, out_vocab: int):
    """prefill_slots_chunk on a (dp, tp) mesh (`cfg` the shard's dims,
    `slots` global). The host has routed each request's row to the dp
    shard that owns its slot and padded every shard to the same row count
    M = N / dp (rows [d*M, (d+1)*M) go to shard d); padding rows are marked
    invalid, and their cache writes are dropped, so a padding row may name
    any local slot. The M slots of a shard must be distinct and its own.
    Each shard runs one [M, C] forward; the logits are all-gathered over dp
    (rows of invalid entries are garbage). Returns (logits [N, V], k, v)."""
    bl, n = _slots_of(k_cache), len(slots)
    if n % mesh.dp:
        raise ValueError(f"{n} rows do not split over dp={mesh.dp}")
    m = n // mesh.dp
    mine = range(mesh.dp_idx * m, (mesh.dp_idx + 1) * m)
    lslots = [slots[i] - mesh.dp_idx * bl for i in mine]
    if any(not 0 <= s < bl for s in lslots) or len(set(lslots)) != m:
        raise ValueError(f"rows {list(mine)} name slots "
                         f"{[slots[i] for i in mine]}: shard {mesh.dp_idx} "
                         f"needs {m} distinct slots of its own")
    ok = [bool(valid[i]) for i in mine]
    logits, k_cache, v_cache = prefill_slots_chunk(
        params, cfg, k_cache, v_cache, [tokens[i] for i in mine], lslots,
        start_pos, [last_pos[i] for i in mine], mode=mode, fuse=fuse,
        valid=None if all(ok) else ok, group=mesh.tp_group,
        out_vocab=out_vocab)
    if mesh.dp_group is not None:
        logits = mesh.dp_group.cat(logits, 0)
    return logits, k_cache, v_cache


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
    _t_admit: int = 0           # perf_counter_ns at admission
    _t_submit: int = 0          # perf_counter_ns at submit, while spans record

    @property
    def ms_per_token(self) -> float:
        return self.generate_ms / max(len(self.out_ids), 1)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None


class BatchedEngine:
    """Continuous-batching server over a fixed slot pool."""

    def __init__(self, path: str, *, max_batch: int = 8, seq_len: int = 1024,
                 mode: str = "bf16", temperature: float = 1.0,
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
        core.

        `tp`/`dp` > 1 serves on a (dp, tp) mesh (parallel/sharding.py::
        make_mesh): this process is one rank of a torch.distributed world
        of at least dp * tp ranks (started by serve.py's --tp/--dp or
        parallel/launch.py), and every rank builds the engine and serves
        the same requests. Weights are tensor-parallel (pallas modes; the
        rank reads its own shard, parallel/tp.py), the KV cache holds the
        rank's kv heads and its dp share of the slots (max_batch % dp == 0),
        and the per-slot state stays whole on every rank's host. Injected
        `params` are then the rank's shard."""
        check_mode(mode)
        if aot_dir is not None:
            raise NotImplementedError(
                "aot_dir (the TPU's compiled-executable cache) is not ported")
        if attn not in ("auto", "dense", "flash", "fused"):
            raise NotImplementedError(f"attn={attn!r} is not ported yet")
        if max_batch % dp:
            raise ValueError(f"max_batch={max_batch} must divide over "
                             f"dp={dp}")
        if tp * dp > 1 and not mode.startswith("pallas"):
            # the mesh programs take the tensor-parallel pallas pack
            # (parallel/shard_layout.py), as the JAX package's shard_map
            # programs
            raise ValueError("tp/dp>1 serving requires a pallas mode")
        self.device = resolve_device(device)
        self._mesh = make_mesh(dp=dp, tp=tp, device=self.device)
        self.tokenizer = Tokenizer.from_file(path, native_tokenizer)
        if params is not None:
            if model_cfg is None:
                raise ValueError("params injection needs model_cfg")
            mc, self.params = model_cfg, params
        else:
            mc, self.params = load_params(
                path, mode=mode, max_seq_len=seq_len, device=self.device,
                tp=tp, rank=self._mesh.tp_idx)
        self.cfg: ModelConfig = mc.with_seq_len(seq_len)
        self._loc = local_config(self.cfg, tp)     # the shard's dims
        self.mode = mode
        self.fuse = fuse
        if attn == "auto":
            # the JAX engine's rule: flash only single-stream at long
            # context, else the fused batched kernel on the side buffer in
            # a pallas mode, else dense
            attn = ("flash" if max_batch == 1 and seq_len >= 8192
                    else "fused" if (side_buffer
                                     and mode.startswith("pallas"))
                    else "dense")
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
        self._kv = init_kv_cache(self._loc, B // dp, cache_rows, kv_dtype,
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
        if SPANS.on:
            req._t_submit = SPANS.clock()
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

    def _admissible(self) -> bool:
        """Whether _admit would admit anything: a chat turn whose pinned
        slot is free, or a fresh request and a free unpinned slot."""
        if any(r.slot is not None and self._slots[r.slot].req is None
               for r in self._queue):
            return True
        return (any(r.slot is None for r in self._queue)
                and any(s.req is None and b not in self._pinned
                        for b, s in enumerate(self._slots)))

    def _admit(self) -> None:
        if not self._admissible():
            return
        sid = SPANS.begin("admit")
        try:
            self._admit_queued()
        finally:
            SPANS.end(sid)

    def _admit_queued(self) -> None:
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
        sid = SPANS.begin("admit.encode")
        encoded = [(b, req, self.tokenizer.encode(req.prompt)
                    [: self.cfg.seq_len]) for b, req in assigned]
        SPANS.end(sid)
        for b, req, ids in encoded:
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
            # bytes a slot of the whole cache holds (a rank's cache holds
            # 1 / (tp * dp) of them)
            per_row = (sum(t.numel() * t.element_size()
                           for side in self._kv for t in kvcache.tensors(side))
                       * self._mesh.tp * self._mesh.dp
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

    def _queued(self, req: Request, t: int) -> None:
        """The `queue` span of `req`: from its submit to `t` (ns), the start
        of its own admission."""
        if req._t_submit:
            SPANS.add("queue", req._t_submit, t, rid=req.rid)

    def _admit_batch(self, items: list, plan: tuple) -> None:
        t0 = time.perf_counter_ns()
        rids = None
        if SPANS.on:
            rids = tuple(req.rid for _, req, _ in items)
            for _, req, _ in items:
                self._queued(req, t0)
        group = SPANS.begin("admit.group", rid=rids, start=t0)
        temps, topps = [], []
        for b, req, ids in items:
            r_temp, r_topp = self._sampler_of(b, req)
            req.prompt_ids = ids
            temps.append(r_temp)
            topps.append(r_topp)
        rows, item_row = self._dp_rows(items)
        slots = [slot for slot, _ in rows]
        valid = [ids is not None for _, ids in rows]
        k, v = self._kv
        logits = None
        for off, size in plan:
            blocks, lasts = [], []
            for _, ids in rows:
                blk = [] if ids is None else ids[off:off + size]
                lasts.append(max(len(blk) - 1, 0))
                blocks.append(blk + [0] * (size - len(blk)))
                COUNTS["prefill_valid_rows"] += len(blk)
            sid = SPANS.begin("prefill.block", rid=rids)
            logits, k, v = mesh_prefill_slots_chunk(
                self._mesh, self.params, self._loc, k, v, blocks, slots,
                valid, off, lasts, mode=self.mode, fuse=self.fuse,
                out_vocab=self.cfg.vocab_size)
            SPANS.end(sid)
            COUNTS["prefill_forwards"] += 1
            COUNTS["prefill_rows"] += len(rows) * size
        self._kv = (k, v)
        if item_row is not None:
            logits = logits[torch.tensor(item_row, device=logits.device)]
        seeds = [req.seed & _M64 for _, req, _ in items]
        sid = SPANS.begin("first_tokens", rid=rids)
        toks, rngs = first_tokens_batch(logits, seeds, temps, topps,
                                        top_k=self.top_k)
        SPANS.end(sid)
        now = time.perf_counter_ns()
        SPANS.end(group, now)
        COUNTS["admit_groups"] += 1
        COUNTS["admitted"] += len(items)
        for (b, req, ids), tok, rng in zip(items, toks, rngs):
            req.prompt_ms = (now - t0) / 1e6
            req._t_admit = now
            self._start(b, req, tok, len(ids), rng)

    def _dp_rows(self, items: list):
        """Batched admission's rows on the mesh: each request's row goes to
        the dp shard that owns its slot, and every shard is padded to a
        common row count M with rows of its free slots (ids None: their
        cache writes are dropped). Returns ([(slot, ids | None)] in shard
        order, the row of each item); at dp = 1 the items' own rows, in
        order, and None."""
        dp = self._mesh.dp
        if dp == 1:
            return [(b, ids) for b, _, ids in items], None
        bl = self.max_batch // dp
        per: list[list[int]] = [[] for _ in range(dp)]
        for i, (b, _, _) in enumerate(items):
            per[b // bl].append(i)
        M = max(len(g) for g in per)
        rows: list[tuple[int, Optional[list]]] = []
        item_row = [0] * len(items)
        for d, g in enumerate(per):
            used = {items[i][0] for i in g}
            free = iter(s for s in range(d * bl, (d + 1) * bl)
                        if s not in used)
            for i in g:
                item_row[i] = len(rows)
                rows.append((items[i][0], items[i][2]))
            for _ in range(M - len(g)):
                rows.append((next(free), None))
        return rows, item_row

    def _admit_into(self, b: int, req: Request) -> None:
        t0 = time.perf_counter_ns()
        self._queued(req, t0)
        group = SPANS.begin("admit.group", rid=req.rid, start=t0)
        ids = self.tokenizer.encode(req.prompt)
        # never run past the context (reference chat clips the same way)
        ids = ids[: self.cfg.seq_len - req.start_pos]
        if not ids:
            req.finished = True
            SPANS.end(group)
            return
        r_temp, r_topp = self._sampler_of(b, req)
        req.prompt_ids = ids

        # chunked prefill with the same block plan as Engine._prefill
        k, v = self._kv
        logits = None
        for off, block, n_valid in prefill_blocks(
                ids, req.start_pos, self.prefill_bucket, self.cfg.seq_len):
            sid = SPANS.begin("prefill.block", rid=req.rid)
            logits, k, v = mesh_prefill_slot_chunk(
                self._mesh, self.params, self._loc, k, v, block, b,
                req.start_pos + off, n_valid - 1, mode=self.mode,
                fuse=self.fuse, out_vocab=self.cfg.vocab_size)
            SPANS.end(sid)
            COUNTS["prefill_forwards"] += 1
            COUNTS["prefill_rows"] += len(block)
            COUNTS["prefill_valid_rows"] += n_valid
        self._kv = (k, v)

        rng = req.seed & _M64 if req.rng is None else req.rng
        n_burn = len(ids) - 1 if req.burn_prompt else 0
        sid = SPANS.begin("first_tokens", rid=req.rid)
        tok, rng = burn_and_sample(logits, rng, n_burn, r_temp, r_topp,
                                   greedy=r_temp <= GREEDY_EPS,
                                   top_k=self.top_k)
        SPANS.end(sid)
        now = time.perf_counter_ns()
        SPANS.end(group, now)
        COUNTS["admit_groups"] += 1
        COUNTS["admitted"] += 1
        req.prompt_ms = (now - t0) / 1e6
        req._t_admit = now
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
        sid = SPANS.begin("chunk", counts=COUNTS)
        try:
            return self._chunk()
        finally:
            SPANS.end(sid)

    def _chunk(self) -> list[Request]:
        all_greedy = bool((self._temp <= GREEDY_EPS).all())
        k, v = self._kv
        packed, k, v, tok, pos, done, rng = batched_decode_chunk(
            self.params, self._loc, k, v, self._token, self._pos,
            self._limit, self._done, self._rng, self._temp, self._topp,
            self._emit, chunk=self.decode_chunk, greedy=all_greedy,
            bos=self.tokenizer.special.bos, eos=self.tokenizer.special.eos,
            top_k=self.top_k, attn=self.attn, mode=self.mode,
            use_side=self.side_buffer, bucket=self._bucket(), fuse=self.fuse,
            group=self._mesh.tp_group, dp_group=self._mesh.dp_group,
            out_vocab=self.cfg.vocab_size, counts=COUNTS)
        self._kv = (k, v)
        self._token, self._pos, self._done, self._rng = tok, pos, done, rng
        finished = []
        sid = SPANS.begin("chunk.deliver")
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
                req.generate_ms = (time.perf_counter_ns()
                                   - req._t_admit) / 1e6
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
        SPANS.end(sid)
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
