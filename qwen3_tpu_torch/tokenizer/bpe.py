"""Byte-level BPE tokenizer.

Semantics match the reference C tokenizer exactly (src/tokenizer.c:177-287):

1. Pre-tokenize the UTF-8 byte stream: at each `<`, scan forward up to
   `max_len` bytes for `>`; if the bracketed substring is a vocab token,
   consume it whole (special-token path). Otherwise emit the single byte's
   token (byte-level vocab contains all 256 raw bytes).
2. Greedy merge to fixpoint: repeatedly merge the adjacent pair whose
   concatenation is a vocab token with the highest score; ties broken by the
   leftmost pair (the C scan uses strict `>`, so the first maximal hit wins).

The reference implements step 2 as an O(T^2 * V) rescan with O(V) linear
token lookups; this implementation keeps identical selection semantics with a
hash-map vocab and a lazy heap (O(T log T)), so prompt processing is not a
bottleneck. Any vocab entry is a merge candidate (scores default to -1e6 for
base/special/pad tokens, still above the C scan's -1e10 sentinel).

`use_native` (default on) encodes through the native C++ core
(tokenizer/native.py), the same ids faster; without g++ the Python encode
runs. The entry points pass config.native_tokenizer_from_env(), the JAX
package's QWEN3_TPU_NATIVE_TOKENIZER; nothing here reads the environment.
"""

from __future__ import annotations

import heapq

from qwen3_tpu_torch.io.tokenizer_bin import (
    TokenizerData,
    dumps_tokenizer_bin,
    load_tokenizer_bin,
)


class Tokenizer:
    def __init__(self, data: TokenizerData, use_native: bool = True):
        self._data = data
        self.tokens = data.tokens
        self.scores = data.scores
        self.special = data.special
        self.max_len = data.max_len
        # First id wins on duplicate token bytes (C token_to_id returns the
        # first strcmp match, src/tokenizer.c:150-168).
        self._vocab: dict[bytes, int] = {}
        for i, tok in enumerate(data.tokens):
            self._vocab.setdefault(tok, i)
        self._native = None
        if use_native:
            from qwen3_tpu_torch.tokenizer.native import load_native

            self._native = load_native(dumps_tokenizer_bin(data))

    @classmethod
    def from_file(cls, path: str, use_native: bool = True) -> "Tokenizer":
        """Load `<path>.tokenizer` (suffix appended like the C loader)."""
        if not path.endswith(".tokenizer"):
            path = path + ".tokenizer"
        return cls(load_tokenizer_bin(path), use_native)

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- mapping ------------------------------------------------------------

    def id_to_token(self, token_id: int) -> bytes:
        return self.tokens[token_id]

    def token_to_id(self, token: bytes) -> int:
        return self._vocab.get(token, -1)

    def decode(self, ids) -> bytes:
        return b"".join(self.tokens[i] for i in ids)

    # -- encoding -----------------------------------------------------------

    def _pre_tokenize(self, data: bytes) -> list[int]:
        """Byte/special-token scan (src/tokenizer.c:177-227)."""
        ids: list[int] = []
        i, n = 0, len(data)
        while i < n:
            tid = -1
            if data[i] == ord("<"):
                # scan up to max_len bytes for '>'
                end = min(n, i + self.max_len)
                j = data.find(b">", i, end)
                if j != -1:
                    tid = self._vocab.get(data[i:j + 1], -1)
                    if tid != -1:
                        i = j + 1
            if tid == -1:
                tid = self._vocab.get(data[i:i + 1], -1)
                i += 1
            if tid != -1:
                ids.append(tid)
            # else: unknown byte dropped (cannot happen with byte-level vocab)
        return ids

    def _merge(self, ids: list[int]) -> list[int]:
        """Greedy best-score merges via doubly-linked list + lazy heap."""
        n = len(ids)
        if n < 2:
            return ids
        tok = list(ids)            # node -> current token id (-1 = dead)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        version = [0] * n

        heap: list[tuple[float, int, int, int, int, int, int]] = []

        def push(a: int, b: int) -> None:
            if a == -1 or b == -1:
                return
            merged = self._vocab.get(self.tokens[tok[a]] + self.tokens[tok[b]], -1)
            if merged != -1:
                # (-score, left-node index) reproduces the C scan's strict-'>'
                # leftmost tie-break: node indices are monotone in sequence
                # order and a merged node keeps its left constituent's index.
                heapq.heappush(
                    heap,
                    (-self.scores[merged], a, merged, b, version[a], version[b]),
                )

        for a in range(n - 1):
            push(a, a + 1)

        while heap:
            neg_s, a, merged, b, va, vb = heapq.heappop(heap)
            if tok[a] == -1 or tok[b] == -1:
                continue
            if version[a] != va or version[b] != vb or nxt[a] != b:
                continue
            # merge b into a
            tok[a] = merged
            version[a] += 1
            tok[b] = -1
            nxt[a] = nxt[b]
            if nxt[b] != -1:
                prv[nxt[b]] = a
            push(prv[a], a)
            push(a, nxt[a])

        out: list[int] = []
        node = 0
        while node != -1:
            if tok[node] != -1:
                out.append(tok[node])
            node = nxt[node]
        return out

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else text
        if self._native is not None:
            return self._native.encode(data)
        return self._merge(self._pre_tokenize(data))

    def encode_python(self, text: str | bytes) -> list[int]:
        """The Python encode, whatever `use_native` (the native core's
        cross-check)."""
        data = text.encode("utf-8") if isinstance(text, str) else text
        return self._merge(self._pre_tokenize(data))
