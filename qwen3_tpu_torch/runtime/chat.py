"""Multi-turn chat session with the reference's template and semantics
(src/completion.c:174-353):

  system turn:  <|im_start|>system\\n{content}<|im_end|>\\n
  user turn:    <|im_start|>user\\n{content}<|im_end|>\\n<|im_start|>assistant\\n
  think off:    appends <think>\\n\\n</think>\\n   (THINK_OFF injects an empty
                reasoning block; thinking enabled leaves the model free to emit
                its own <think> section)

Context overflow resets the conversation (pos -> 0), matching the C engine
(src/completion.c:281-284). The KV cache need not be cleared: attention only
ever reads slots 0..pos.

RNG parity: the C chat loop calls sample() after *every* forward, including
prompt-consumption steps, so each prompt token burns one xorshift draw
(src/completion.c:318-323). `ChatSession` reproduces that by discarding
len(prompt)-1 coins around the batched prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

from qwen3_tpu_torch.runtime.engine import Engine


def render_system(engine: Engine, content: str) -> bytes:
    t = engine.tokenizer
    return (t.id_to_token(t.special.eot) + b"system\n" +
            content.encode("utf-8") + t.id_to_token(t.special.eos) + b"\n")


def render_user(engine: Engine, content: str, think: bool) -> bytes:
    t = engine.tokenizer
    out = (t.id_to_token(t.special.eot) + b"user\n" +
           content.encode("utf-8") + t.id_to_token(t.special.eos) + b"\n" +
           t.id_to_token(t.special.eot) + b"assistant\n")
    if not think:
        out += (t.id_to_token(t.special.bor) + b"\n\n" +
                t.id_to_token(t.special.eor) + b"\n")
    return out


@dataclasses.dataclass
class TurnMetrics:
    prompt_ms: float
    generate_ms: float
    n_tokens: int

    @property
    def ms_per_token(self) -> float:
        return self.generate_ms / max(self.n_tokens, 1)


class ChatSession:
    def __init__(self, engine: Engine, system_prompt: Optional[str] = None):
        self.engine = engine
        self.system_prompt = system_prompt
        self.pos = 0
        self.last_metrics: Optional[TurnMetrics] = None
        self.last_stop: Optional[str] = None   # "eos" | "limit"
        engine.reset(batch=1)

    def send(self, user_text: str,
             stream_cb: Optional[Callable[[bytes], None]] = None) -> bytes:
        """Run one user turn; returns the assistant's raw byte response."""
        return b"".join(self.stream(user_text, stream_cb))

    def stream(self, user_text: str,
               stream_cb: Optional[Callable[[bytes], None]] = None
               ) -> Iterator[bytes]:
        eng = self.engine
        t = eng.tokenizer
        seq_len = eng.model_cfg.seq_len

        # context overflow => full reset (reference behavior)
        if self.pos >= seq_len:
            self.pos = 0

        rendered = b""
        if self.pos == 0 and self.system_prompt:
            rendered += render_system(eng, self.system_prompt)
        rendered += render_user(eng, user_text, eng.cfg.think)

        t0 = time.perf_counter()
        ids = t.encode(rendered)
        ids = ids[: seq_len - self.pos]  # never run past the context
        if not ids:
            return

        logits = eng._prefill(ids, self.pos)
        # reference chat burns one RNG draw per prompt forward; the draw at
        # the last prompt position is the one that samples the first token
        token = eng._first_token(logits, len(ids) - 1)
        self.pos += len(ids)
        t1 = time.perf_counter()

        n_tokens = 0
        # emit_at_limit: the reference emits the token sampled at the final
        # position and only then hits the overflow check
        for toks, _done in eng._decode_chunks(token, self.pos, seq_len,
                                              emit_at_limit=True):
            piece = t.decode(toks)
            if stream_cb:
                stream_cb(piece)
            yield piece
            n_tokens += len(toks)
        self.pos = int(eng._last_pos)
        self.last_stop = "limit" if self.pos >= seq_len else "eos"
        t2 = time.perf_counter()

        self.last_metrics = TurnMetrics(
            prompt_ms=(t1 - t0) * 1e3, generate_ms=(t2 - t1) * 1e3,
            n_tokens=n_tokens,
        )
