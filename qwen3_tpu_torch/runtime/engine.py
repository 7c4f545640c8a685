"""Engine: checkpoint + tokenizer + sampler assembly and generation loops.

Mirrors the reference facade (src/qwen.c:14-49 `qwen_create`) and completion
loop (src/completion.c:24-84), with qwen3_tpu/runtime/engine.py's contract:

- the prompt prefills in chunked batched forward passes on the graded block
  plan (runtime/decode_loop.py::prefill_plan);
- decode runs in chunks of `decode_chunk` tokens through one of the JAX
  engine's three programs (`EngineConfig.decode_impl`): the serving
  program at B=1 with per-slot KV writes ("slot", the default) or with the
  chunk side buffer ("side"), or the B=1 chunk whose loop stays on the
  device ("fused", runtime/decode_loop.py::decode_chunk);
- the xorshift64* state carries across chunks and chat turns, so seeded
  streams reproduce the C engine token for token;
- the engine runs on a (1, tp) mesh (parallel/sharding.py), (1, 1) by
  default. At `tp` > 1 this process is one rank of a torch.distributed
  world (the CLI's --tp starts the ranks), the weights and the KV cache are
  the rank's shard, every forward reduces over the mesh's tp group, and
  decode always runs the fused chunk, as in the JAX engine. Every rank
  samples the same ids from the same logits.

The engine runs on `EngineConfig.device`, "cuda" by default; asking for CUDA
without a card raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from qwen3_tpu_torch.config import MAX_SEQ_LEN, ModelConfig
from qwen3_tpu_torch.io.checkpoint import read_header
from qwen3_tpu_torch.models.qwen3 import (
    check_mode,
    forward,
    init_kv_cache,
    load_params,
    resolve_device,
)
from qwen3_tpu_torch.parallel.shard_layout import local_config
from qwen3_tpu_torch.parallel.sharding import make_mesh
from qwen3_tpu_torch.runtime.decode_loop import (
    GREEDY_EPS,
    batched_decode_chunk,
    burn_and_sample,
    decode_chunk,
    prefill_blocks,
)
from qwen3_tpu_torch.runtime.kvcache import pad_rows
from qwen3_tpu_torch.runtime.sampler import Sampler
from qwen3_tpu_torch.runtime.xorshift import (
    from_device_state,
    to_device_state,
)
from qwen3_tpu_torch.tokenizer import Tokenizer

FLASH_DEPTH = 8192
DECODE_IMPLS = ("slot", "side", "fused")


@dataclasses.dataclass
class EngineConfig:
    """Mirror of QwenConfig (include/qwen.h:65-72) + the JAX engine's knobs."""

    path: str
    think: bool = True
    seed: int = 0
    temperature: float = 1.0
    top_p: float = 0.9
    seq_len: int = 0               # 0 -> min(checkpoint max, 32768) like the CLI
    mode: str = "bf16"             # models.qwen3.MODES
    attn: str = "auto"             # "auto" | "dense" | "flash"
    kv_dtype: str = "float32"      # "float32" | "bfloat16" | "int8"
    prefill_chunk: int = 64
    decode_chunk: int = 32         # tokens generated per decode chunk
    top_k: int = 64                # top-k fast path for nucleus sampling (0=off)
    batch: int = 1                 # KV cache rows reset() allocates by default
    tp: int = 1                    # tensor parallelism (one process a rank)
    device: str = "cuda"
    fuse: bool = False             # prologue-fused matmuls (pallas modes)
    native_tokenizer: bool = True  # encode with the native C++ core
    # decode program (qwen3_tpu's EngineConfig.decode_impl):
    #   "slot"  - the serving engine's program at B=1 (runtime/batched.py,
    #             direct KV writes); bit-equal to BatchedEngine(
    #             side_buffer=False);
    #   "side"  - the same program with side-buffer KV staging; bit-equal
    #             to BatchedEngine(side_buffer=True), the serving default;
    #   "fused" - the B=1 chunk with its loop on the device
    #             (decode_loop.decode_chunk), one host read a chunk. The same
    #             tokens in practice, but its attention runs as a one-token
    #             block, so no bit-parity guarantee against the batched
    #             engine.
    decode_impl: str = "slot"


@dataclasses.dataclass
class GenerationResult:
    ids: list[int]
    text: bytes
    prompt_ms: float = 0.0         # pp: encode + prefill wall ms
    generate_ms: float = 0.0       # tg: decode wall ms
    n_generated: int = 0

    @property
    def ms_per_token(self) -> float:
        return self.generate_ms / max(self.n_generated, 1)


def _not_ported(cfg: EngineConfig) -> None:
    check_mode(cfg.mode)
    if cfg.decode_impl not in DECODE_IMPLS:
        raise ValueError(f"decode_impl={cfg.decode_impl!r}: one of "
                         f"{DECODE_IMPLS}")
    if cfg.attn not in ("auto", "dense", "flash"):
        # "fused" is the serving engine's (runtime/batched.py)
        raise NotImplementedError(f"attn={cfg.attn!r} is not ported yet "
                                  f"for the single-stream engine")


class Engine:
    def __init__(self, cfg: EngineConfig):
        _not_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.tokenizer = Tokenizer.from_file(cfg.path, cfg.native_tokenizer)
        seq_len = cfg.seq_len if cfg.seq_len > 0 else MAX_SEQ_LEN
        self.model_cfg: ModelConfig = read_header(cfg.path).with_seq_len(
            seq_len)
        self._mesh = make_mesh(dp=1, tp=cfg.tp, device=self.device)
        self._loc = local_config(self.model_cfg, cfg.tp)  # the shard's dims
        _, self.params = load_params(
            cfg.path, mode=cfg.mode, max_seq_len=self.model_cfg.seq_len,
            device=self.device, tp=cfg.tp, rank=self._mesh.tp_idx)
        # tp > 1 decodes through the fused chunk (the JAX engine's rule)
        self._decode_impl = "fused" if cfg.tp > 1 else cfg.decode_impl
        self.sampler = Sampler(self.tokenizer.vocab_size, cfg.temperature,
                               cfg.top_p, cfg.seed)
        # greedy shortcut: at the epsilon temperature the reference's top-p
        # path reduces to argmax (up to exact fp32 logit ties)
        self.greedy = self.sampler.temperature <= GREEDY_EPS
        self.kv_dtype = cfg.kv_dtype
        self._kv = None
        self._rng = cfg.seed & ((1 << 64) - 1)
        self._last_pos = 0

    # -- state ---------------------------------------------------------------

    def reset(self, batch: int | None = None):
        """A fresh KV cache of `batch` rows (default `EngineConfig.batch`).
        The side program merges a whole chunk window past a stream's last
        position, so its cache has `decode_chunk` rows more; every cache is
        padded to the flash kernels' 256-row tile. At tp > 1 the cache is
        the rank's kv heads."""
        extra = self.cfg.decode_chunk if self._decode_impl == "side" else 0
        self._kv = init_kv_cache(
            self._loc, self.cfg.batch if batch is None else batch,
            pad_rows(self.model_cfg.seq_len + extra), self.kv_dtype,
            self.device)

    def reset_rng(self):
        """Back to the seed's xorshift state (the RNG otherwise carries
        across generations and chat turns)."""
        self._rng = self.cfg.seed & ((1 << 64) - 1)

    def _attn_for(self, depth: int) -> str:
        """Resolve attn="auto" per dispatch from the actual attention depth:
        flash at depth >= 8192, dense below (the JAX engine's rule). A
        prefill block is decided by its start, a decode chunk by the depth
        at its first step, so a chunk that starts at 8190 runs dense for all
        its steps."""
        if self.cfg.attn != "auto":
            return self.cfg.attn
        return "flash" if depth >= FLASH_DEPTH else "dense"

    # -- forward helpers -----------------------------------------------------

    def _prefill(self, ids: list[int], start_pos: int) -> torch.Tensor:
        """Chunked batched prefill; returns logits at the last prompt position."""
        cfg, chunk = self.model_cfg, self.cfg.prefill_chunk
        k, v = self._kv
        logits = None
        for off, block, n_valid in prefill_blocks(ids, start_pos, chunk,
                                                  cfg.seq_len):
            toks = torch.tensor([block], dtype=torch.int64,
                                device=self.device)
            lg, k, v = forward(self.params, self._loc, toks, k, v,
                               start_pos + off, mode=self.cfg.mode,
                               attn=self._attn_for(start_pos + off),
                               last_pos=n_valid - 1, fuse=self.cfg.fuse,
                               group=self._mesh.tp_group,
                               out_vocab=cfg.vocab_size)
            logits = lg[:, 0]
        self._kv = (k, v)
        return logits  # [1, V]

    def _first_token(self, logits: torch.Tensor, n_burn: int) -> int:
        """Sample the first generated token after n_burn discarded RNG draws
        (chat burns one per prompt token like the C loop)."""
        tok, self._rng = burn_and_sample(
            logits[0], self._rng, n_burn, self.sampler.temperature,
            self.sampler.top_p, greedy=self.greedy, top_k=self.cfg.top_k)
        return tok

    def _decode_chunks(self, token: int, pos: int, limit: int,
                       emit_at_limit: bool):
        """Yield (np_tokens, done) per decode chunk until stop/limit, in the
        program `decode_impl` names; at tp > 1 always the fused chunk on the
        mesh (the JAX engine's rule)."""
        if self._decode_impl == "fused":
            yield from self._decode_chunks_fused(token, pos, limit,
                                                 emit_at_limit)
            return
        k, v = self._kv
        t = self.tokenizer
        chunk = self.cfg.decode_chunk
        state = dict(token=[token], pos=[pos], done=[False], rng=[self._rng])
        done = False
        cur = pos                      # host-tracked depth for attn="auto"
        while not done:
            packed, k, v, tok_a, pos_a, done_a, rng = batched_decode_chunk(
                self.params, self._loc, k, v, state["token"],
                state["pos"], [limit], state["done"], state["rng"],
                [self.sampler.temperature], [self.sampler.top_p],
                [emit_at_limit], chunk=chunk, greedy=self.greedy,
                bos=t.special.bos, eos=t.special.eos, top_k=self.cfg.top_k,
                attn=self._attn_for(cur), mode=self.cfg.mode,
                use_side=self._decode_impl == "side", fuse=self.cfg.fuse,
                group=self._mesh.tp_group,
                out_vocab=self.model_cfg.vocab_size)
            state = dict(token=tok_a, pos=pos_a, done=done_a, rng=rng)
            row = packed[0]
            cur = int(row[-2])
            toks = row[:chunk]
            toks = toks[toks >= 0]
            done = bool(row[-1])
            self._kv = (k, v)
            self._rng = rng[0]
            self._last_pos = int(pos_a[0])
            if len(toks):
                yield toks, done
            else:
                break

    def _decode_chunks_fused(self, token: int, pos: int, limit: int,
                             emit_at_limit: bool):
        """The "fused" program: decode_chunk until stop/limit, one read of
        `packed` a chunk. Token and RNG stay on the device across chunks;
        the position follows on the host from `packed`; the RNG comes back
        to the host state once the stream ends, for the next turn."""
        k, v = self._kv
        t = self.tokenizer
        tok = torch.full((1,), token, dtype=torch.int64, device=self.device)
        hi, lo = to_device_state(self._rng, self.device)
        while True:
            packed, k, v, tok, _, hi, lo = decode_chunk(
                self.params, self._loc, k, v, tok, pos, limit, hi, lo,
                mode=self.cfg.mode, chunk=self.cfg.decode_chunk,
                temperature=self.sampler.temperature,
                top_p=self.sampler.top_p, greedy=self.greedy,
                bos=t.special.bos, eos=t.special.eos,
                emit_at_limit=emit_at_limit, top_k=self.cfg.top_k,
                attn=self._attn_for(pos), fuse=self.cfg.fuse,
                group=self._mesh.tp_group,
                out_vocab=self.model_cfg.vocab_size)
            row = packed.cpu().numpy()     # the one host read a chunk
            n, done = int(row[-2]), bool(row[-1])
            pos = min(pos + n, limit)
            self._kv = (k, v)
            self._last_pos = pos
            if n:
                yield row[:n], done
            if done or n == 0:
                break
        self._rng = from_device_state(hi, lo)

    # -- completion (single turn) ---------------------------------------------

    def generate(self, prompt: str | bytes,
                 stream_cb: Optional[Callable[[bytes], None]] = None,
                 max_tokens: Optional[int] = None) -> GenerationResult:
        """Single-turn completion with reference semantics
        (src/completion.c:24-84): teacher-force the prompt, then sample until
        BOS/EOS or the context limit; the stop token itself is not emitted."""
        t = self.tokenizer
        t0 = time.perf_counter()
        ids = t.encode(prompt)
        if not ids:
            raise ValueError("empty prompt")
        seq_len = self.model_cfg.seq_len
        ids = ids[:seq_len]

        self.reset(batch=1)
        logits = self._prefill(ids, 0)
        token = self._first_token(logits, 0)
        t1 = time.perf_counter()

        out_ids = list(ids)
        if stream_cb:
            stream_cb(t.decode(ids))

        limit = seq_len if max_tokens is None else min(
            seq_len, len(ids) + max_tokens)
        n_gen = 0
        for toks, _done in self._decode_chunks(token, len(ids), limit,
                                               emit_at_limit=False):
            out_ids.extend(int(x) for x in toks)
            n_gen += len(toks)
            if stream_cb:
                stream_cb(t.decode(toks))
        t2 = time.perf_counter()

        return GenerationResult(
            ids=out_ids, text=t.decode(out_ids),
            prompt_ms=(t1 - t0) * 1e3, generate_ms=(t2 - t1) * 1e3,
            n_generated=n_gen,
        )
