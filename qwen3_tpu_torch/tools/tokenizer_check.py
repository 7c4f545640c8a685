"""Tokenizer encode/decode round-trip printer
(reference examples/tokenizer.c:12-52), the counterpart of
qwen3_tpu/tools/tokenizer_check.py.

    python -m qwen3_tpu_torch.tools.tokenizer_check <model.bin> <text> \
        [text ...]

Prints token ids and the decoded round-trip for each argument; exits
non-zero if any round-trip fails to reproduce the input bytes.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("usage: python -m qwen3_tpu_torch.tools.tokenizer_check "
              "<model.bin> <text> [text ...]", file=sys.stderr)
        return 2

    from qwen3_tpu_torch.config import native_tokenizer_from_env
    from qwen3_tpu_torch.tokenizer.bpe import Tokenizer

    tok = Tokenizer.from_file(argv[0], native_tokenizer_from_env())
    print(f"[Tokenizer] vocab={tok.vocab_size} bos={tok.special.bos} "
          f"eos={tok.special.eos}", file=sys.stderr)
    rc = 0
    for text in argv[1:]:
        ids = tok.encode(text)
        back = tok.decode(ids)
        ok = back == text.encode("utf-8")
        rc |= 0 if ok else 1
        print(f"input : {text!r}")
        print(f"ids   : {ids}")
        print(f"decode: {back!r}  [{'ok' if ok else 'MISMATCH'}]")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
