"""ctypes binding for the native C++ tokenizer core (the port's own copy of
native/tokenizer.cpp, qwen3_tpu_torch/native/tokenizer.cpp).

The counterpart of qwen3_tpu/tokenizer/native.py. g++ builds the shared
library at first use into build/qwen3_tpu_torch/ under the repository root
(again whenever the source is newer); `NativeTokenizer` is a drop-in for the
encode path of tokenizer.bpe.Tokenizer (the same ids, 10-50x faster on long
prompts). Where g++ or the build fails, `load_native` returns None and the
tokenizer keeps its Python encode: host code either way, with the same ids.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "tokenizer.cpp"
_LIB = _PKG.parent / "build" / "qwen3_tpu_torch" / "libqtok.so"

_lib = None


def _build() -> Path | None:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"libqtok.{os.getpid()}.so")
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, _LIB)  # atomic: a concurrent loader never sees half a file
    return _LIB


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.qtok_create.restype = ctypes.c_void_p
    lib.qtok_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.qtok_free.argtypes = [ctypes.c_void_p]
    lib.qtok_vocab_size.restype = ctypes.c_int32
    lib.qtok_vocab_size.argtypes = [ctypes.c_void_p]
    lib.qtok_encode.restype = ctypes.c_int32
    lib.qtok_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    _lib = lib
    return lib


class NativeTokenizer:
    """Native encode core over a serialized .tokenizer blob."""

    def __init__(self, blob: bytes):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native tokenizer unavailable")
        self._lib = lib
        self._h = lib.qtok_create(blob, len(blob))
        if not self._h:
            raise ValueError("bad tokenizer blob")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qtok_free(self._h)
            self._h = None

    @property
    def vocab_size(self) -> int:
        return self._lib.qtok_vocab_size(self._h)

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else text
        cap = max(len(data), 16)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.qtok_encode(self._h, data, len(data), buf, cap)
        if n < 0:
            raise RuntimeError("tokenizer output overflow")
        return list(buf[:n])


def load_native(blob: bytes) -> NativeTokenizer | None:
    try:
        return NativeTokenizer(blob)
    except (RuntimeError, ValueError):
        return None
