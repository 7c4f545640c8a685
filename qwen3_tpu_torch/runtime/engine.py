"""Engine: checkpoint + tokenizer + sampler assembly and generation loops.

Mirrors the reference facade (src/qwen.c:14-49 `qwen_create`) and completion
loop (src/completion.c:24-84), with qwen3_tpu/runtime/engine.py's contract:

- the prompt prefills in chunked batched forward passes on the graded block
  plan (runtime/decode_loop.py::prefill_plan);
- decode runs the serving program's step at B=1 (per-slot KV writes, the JAX
  engine's decode_impl="slot"), in chunks of `decode_chunk` tokens;
- the xorshift64* state carries across chunks and chat turns, so seeded
  streams reproduce the C engine token for token.

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
from qwen3_tpu_torch.runtime.decode_loop import (
    GREEDY_EPS,
    batched_decode_chunk,
    burn_and_sample,
    prefill_blocks,
)
from qwen3_tpu_torch.runtime.kvcache import pad_rows
from qwen3_tpu_torch.runtime.sampler import Sampler
from qwen3_tpu_torch.tokenizer import Tokenizer

FLASH_DEPTH = 8192


@dataclasses.dataclass
class EngineConfig:
    """Mirror of QwenConfig (include/qwen.h:65-72) + the JAX engine's knobs."""

    path: str
    think: bool = True
    seed: int = 0
    temperature: float = 1.0
    top_p: float = 0.9
    seq_len: int = 0               # 0 -> min(checkpoint max, 32768) like the CLI
    mode: str = "pallas"           # models.qwen3.MODES
    attn: str = "auto"             # "auto" | "dense" | "flash"
    kv_dtype: str = "float32"      # "float32" | "bfloat16" | "int8"
    prefill_chunk: int = 64
    decode_chunk: int = 32         # tokens generated per decode chunk
    top_k: int = 64                # top-k fast path for nucleus sampling (0=off)
    tp: int = 1                    # tensor parallelism: not ported yet
    device: str = "cuda"
    fuse: bool = False             # prologue-fused matmuls (pallas modes)
    native_tokenizer: bool = True  # encode with the native C++ core


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
    if cfg.tp != 1:
        raise NotImplementedError("tp > 1 is not ported yet")
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
        _, self.params = load_params(cfg.path, mode=cfg.mode,
                                     max_seq_len=self.model_cfg.seq_len,
                                     device=self.device)
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

    def reset(self):
        self._kv = init_kv_cache(self.model_cfg, 1,
                                 pad_rows(self.model_cfg.seq_len),
                                 self.kv_dtype, self.device)

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
            lg, k, v = forward(self.params, cfg, toks, k, v, start_pos + off,
                               mode=self.cfg.mode,
                               attn=self._attn_for(start_pos + off),
                               last_pos=n_valid - 1, fuse=self.cfg.fuse)
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
        """Yield (np_tokens, done) per decode chunk until stop/limit."""
        k, v = self._kv
        t = self.tokenizer
        chunk = self.cfg.decode_chunk
        state = dict(token=[token], pos=[pos], done=[False], rng=[self._rng])
        done = False
        cur = pos                      # host-tracked depth for attn="auto"
        while not done:
            packed, k, v, tok_a, pos_a, done_a, rng = batched_decode_chunk(
                self.params, self.model_cfg, k, v, state["token"],
                state["pos"], [limit], state["done"], state["rng"],
                [self.sampler.temperature], [self.sampler.top_p],
                [emit_at_limit], chunk=chunk, greedy=self.greedy,
                bos=t.special.bos, eos=t.special.eos, top_k=self.cfg.top_k,
                attn=self._attn_for(cur), mode=self.cfg.mode,
                fuse=self.cfg.fuse)
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

        self.reset()
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
