"""Reader/writer for the `.tokenizer` v2 binary format.

Layout (ref: qwen3/tokenizer.py:247-278, src/tokenizer.c:44-109):

  u32 magic 0x71746B6E ("qtkn"), i32 version (2), i32 vocab_size, i32 max_len,
  10 x i32 special ids (bos, eos, eot, pad, bor, eor, btc, etc, btr, etr),
  then per token: f32 score, i32 byte-length, raw bytes.

Token payloads are raw UTF-8 byte sequences (the exporter inverts the GPT-2
byte<->unicode map before writing).
"""

from __future__ import annotations

import dataclasses
import struct

QTKN_MAGIC = 0x71746B6E  # "qtkn"
QTKN_VERSION = 2


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    bos: int   # <|endoftext|>
    eos: int   # <|im_end|>
    eot: int   # <|im_start|>
    pad: int   # mirrors bos
    bor: int   # <think>
    eor: int   # </think>
    btc: int   # <tool_call>
    etc: int   # </tool_call>
    btr: int   # <tool_response>
    etr: int   # </tool_response>

    def as_tuple(self) -> tuple[int, ...]:
        return (self.bos, self.eos, self.eot, self.pad, self.bor, self.eor,
                self.btc, self.etc, self.btr, self.etr)


@dataclasses.dataclass
class TokenizerData:
    tokens: list[bytes]       # id -> raw token bytes
    scores: list[float]       # id -> merge pseudo-score
    special: SpecialTokens
    max_len: int              # longest token length in bytes

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)


def load_tokenizer_bin(path: str) -> TokenizerData:
    with open(path, "rb") as f:
        data = f.read()
    magic, version, vocab_size, max_len = struct.unpack_from("<Iiii", data, 0)
    if magic != QTKN_MAGIC or version != QTKN_VERSION:
        raise ValueError(f"bad tokenizer header: magic=0x{magic:x} version={version}")
    special = SpecialTokens(*struct.unpack_from("<10i", data, 16))

    tokens: list[bytes] = []
    scores: list[float] = []
    off = 56
    for _ in range(vocab_size):
        score, length = struct.unpack_from("<fi", data, off)
        off += 8
        tokens.append(data[off:off + length])
        off += length
        scores.append(score)
    return TokenizerData(tokens=tokens, scores=scores, special=special, max_len=max_len)


def dumps_tokenizer_bin(t: TokenizerData) -> bytes:
    parts = [struct.pack("<Iiii", QTKN_MAGIC, QTKN_VERSION,
                         t.vocab_size, t.max_len),
             struct.pack("<10i", *t.special.as_tuple())]
    for tok, score in zip(t.tokens, t.scores):
        parts.append(struct.pack("<fi", score, len(tok)))
        parts.append(tok)
    return b"".join(parts)


def write_tokenizer_bin(path: str, t: TokenizerData) -> None:
    with open(path, "wb") as f:
        f.write(dumps_tokenizer_bin(t))
