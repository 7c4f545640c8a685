"""The benchmark's tokenizer: a byte-level vocabulary with no merges.

Ids 0-255 are the raw bytes, then the ten special tokens the format
carries, then padding up to the model's vocabulary. No two-byte token
exists, so nothing merges, and a prompt of bytes that holds no `<` is
its own id list: both sides know a prompt's ids without a BPE.
"""

from __future__ import annotations

from pathlib import Path

SPECIALS = (b"<|endoftext|>", b"<|im_end|>", b"<|im_start|>", b"<think>",
            b"</think>", b"<tool_call>", b"</tool_call>",
            b"<tool_response>", b"</tool_response>")


def write(path: Path, vocab_size: int) -> None:
    """Write `path` in the port's `.tokenizer` format."""
    from qwen3_tpu_torch.io.tokenizer_bin import (
        SpecialTokens,
        TokenizerData,
        write_tokenizer_bin,
    )

    tokens = [bytes([b]) for b in range(256)] + list(SPECIALS)
    ids = {t: 256 + i for i, t in enumerate(SPECIALS)}
    tokens += [f"<|pad_{i}|>".encode() for i in range(len(tokens),
                                                      vocab_size)]
    special = SpecialTokens(
        bos=ids[b"<|endoftext|>"], eos=ids[b"<|im_end|>"],
        eot=ids[b"<|im_start|>"], pad=ids[b"<|endoftext|>"],
        bor=ids[b"<think>"], eor=ids[b"</think>"],
        btc=ids[b"<tool_call>"], etc=ids[b"</tool_call>"],
        btr=ids[b"<tool_response>"], etr=ids[b"</tool_response>"])
    write_tokenizer_bin(str(path), TokenizerData(
        tokens=tokens, scores=[-1e6] * len(tokens), special=special,
        max_len=max(len(t) for t in tokens)))
