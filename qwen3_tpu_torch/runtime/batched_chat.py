"""Multi-turn chat over the continuous-batching engine (qwen3_tpu/runtime/
batched_chat.py, on the port).

Each conversation pins one BatchedEngine slot so its KV rows stay resident
between turns; a turn is an ordinary Request carrying the chat plumbing
(start_pos continuation, xorshift state carry-over, one-burn-per-prompt-token
RNG parity, emit-at-limit) — so conversations interleave freely with
completion traffic on the same slot pool, and each stream is bit-equal to the
single-stream ChatSession for the same seed.

Reference semantics (src/completion.c:257-353): template rendering
(`render_system`/`render_user` from runtime/chat.py), THINK_OFF empty-block
injection, context-overflow-resets-position (the KV need not be cleared —
attention only reads rows < pos), and per-turn pp/tg metrics (carried on the
Request).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request
from qwen3_tpu_torch.runtime.chat import render_system, render_user


@dataclasses.dataclass
class Conversation:
    seed: int
    system_prompt: Optional[str]
    think: bool
    slot: int
    pos: int = 0
    rng: Optional[int] = None        # xorshift state carried across turns
    last_stop: Optional[str] = None  # "eos" | "limit"
    closed: bool = False


class BatchedChat:
    """Conversation manager multiplexing chats over a BatchedEngine."""

    def __init__(self, engine: BatchedEngine):
        self.engine = engine

    def new_conversation(self, seed: int = 0,
                         system_prompt: Optional[str] = None,
                         think: bool = True) -> Conversation:
        return Conversation(seed=seed, system_prompt=system_prompt,
                            think=think, slot=self.engine.pin_slot())

    def close(self, conv: Conversation) -> None:
        self.engine.unpin_slot(conv.slot)
        conv.closed = True

    def submit_turn(self, conv: Conversation, user_text: str,
                    stream_cb: Optional[Callable[[bytes], None]] = None,
                    temperature: Optional[float] = None,
                    top_p: Optional[float] = None) -> Request:
        """Render + enqueue one user turn. Call engine.run() (possibly after
        submitting other turns/requests), then finish_turn()."""
        if conv.closed:
            raise RuntimeError("conversation is closed")
        eng = self.engine
        if conv.pos >= eng.cfg.seq_len:
            conv.pos = 0    # reference: context overflow wipes the turn state
        rendered = b""
        if conv.pos == 0 and conv.system_prompt:
            rendered += render_system(eng, conv.system_prompt)
        rendered += render_user(eng, user_text, conv.think)
        req = Request(prompt=rendered, seed=conv.seed, stream_cb=stream_cb,
                      temperature=temperature, top_p=top_p, slot=conv.slot,
                      start_pos=conv.pos, rng=conv.rng, burn_prompt=True,
                      emit_at_limit=True)
        return eng.submit(req)

    def finish_turn(self, conv: Conversation, req: Request) -> None:
        """Fold a finished turn's end state back into the conversation."""
        assert req.finished, "turn not finished — run the engine first"
        conv.pos = req.end_pos
        conv.rng = req.end_rng
        conv.last_stop = ("limit" if conv.pos >= self.engine.cfg.seq_len
                          else "eos")

    def send(self, conv: Conversation, user_text: str,
             stream_cb: Optional[Callable[[bytes], None]] = None,
             **sampler) -> bytes:
        """Convenience: one turn, run to completion, return the reply."""
        req = self.submit_turn(conv, user_text, stream_cb=stream_cb,
                               **sampler)
        self.engine.run()
        self.finish_turn(conv, req)
        return self.engine.tokenizer.decode(req.out_ids)
