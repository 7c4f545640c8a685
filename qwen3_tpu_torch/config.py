"""Model configuration.

Mirrors the 12-field checkpoint header of the reference format
(ref: qwen3/weights.py:249-293, include/model.h:30-43) plus framework-level knobs
the reference bakes into compile flags or hard-codes.
"""

from __future__ import annotations

import dataclasses
import os

QWEN_MAGIC = 0x7177656E  # "qwen"
QWEN_VERSION = 1
HEADER_BYTES = 256

# Hard-coded in the reference engine (src/forward.c:21, src/forward.c:109).
RMS_EPS = 1e-6
ROPE_THETA = 1e6

# CLI-level context cap in the reference (include/tokenizer.h:27).
MAX_SEQ_LEN = 32768


def fuse_from_env(environ=None) -> bool:
    """QWEN3_TPU_FUSE read as the JAX package reads it (qwen3_tpu/models/
    qwen3.py::_make_fused_linear): "1" turns the prologue-fused matmuls on.
    Only the entry points (the CLI, serve.py, the eval and the quality
    table) call this and pass `fuse` down; nothing below them reads the
    environment."""
    env = os.environ if environ is None else environ
    return env.get("QWEN3_TPU_FUSE", "0") == "1"


def native_tokenizer_from_env(environ=None) -> bool:
    """QWEN3_TPU_NATIVE_TOKENIZER read as the JAX package reads it
    (qwen3_tpu/tokenizer/bpe.py): "1", the default, encodes through the
    native C++ core. Only the entry points call this and pass the result
    down, as with fuse_from_env."""
    env = os.environ if environ is None else environ
    return env.get("QWEN3_TPU_NATIVE_TOKENIZER", "1") == "1"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyperparameters (checkpoint header contents)."""

    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int          # max sequence length baked into the checkpoint
    head_dim: int
    shared_classifier: bool
    group_size: int       # Q8_0 quantization group size (a.k.a. block_size)

    @property
    def proj_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def kv_mul(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> None:
        assert self.dim % self.group_size == 0, "dim must be divisible by group_size"
        assert self.hidden_dim % self.group_size == 0
        assert self.proj_dim % self.group_size == 0
        assert self.n_heads % self.n_kv_heads == 0
        assert self.head_dim % 2 == 0

    def with_seq_len(self, seq_len: int) -> "ModelConfig":
        """Override context length, clamped to the checkpoint max
        (ref behavior: src/model.c:74-76)."""
        if seq_len <= 0 or seq_len > self.seq_len:
            seq_len = self.seq_len
        return dataclasses.replace(self, seq_len=seq_len)


# Architecture presets (HF config.json values; see examples/qwen.c:5-14 for the family).
PRESETS: dict[str, ModelConfig] = {
    # A miniature config for tests / smoke runs (not a real released model).
    "tiny": ModelConfig(
        dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        vocab_size=512, seq_len=128, head_dim=32, shared_classifier=True,
        group_size=32,
    ),
    # Miniature config with the REAL presets' 8-kv-head geometry: exercises
    # tp=4 and tp=8 sharding (tiny's n_kv_heads=2 caps tp at 2). Per-shard
    # dims stay group-aligned at tp=8: hidden 512/8=64, proj 16*32/8=64,
    # both % 32 == 0 (parallel/tp.check_tp).
    "tiny8": ModelConfig(
        dim=128, hidden_dim=512, n_layers=2, n_heads=16, n_kv_heads=8,
        vocab_size=512, seq_len=128, head_dim=32, shared_classifier=True,
        group_size=32,
    ),
    "qwen3-0.6b": ModelConfig(
        dim=1024, hidden_dim=3072, n_layers=28, n_heads=16, n_kv_heads=8,
        vocab_size=151936, seq_len=40960, head_dim=128, shared_classifier=True,
        group_size=64,
    ),
    "qwen3-1.7b": ModelConfig(
        dim=2048, hidden_dim=6144, n_layers=28, n_heads=16, n_kv_heads=8,
        vocab_size=151936, seq_len=40960, head_dim=128, shared_classifier=True,
        group_size=64,
    ),
    "qwen3-4b": ModelConfig(
        dim=2560, hidden_dim=9728, n_layers=36, n_heads=32, n_kv_heads=8,
        vocab_size=151936, seq_len=40960, head_dim=128, shared_classifier=False,
        group_size=64,
    ),
    "deepseek-r1-qwen3-8b": ModelConfig(
        dim=4096, hidden_dim=12288, n_layers=36, n_heads=32, n_kv_heads=8,
        vocab_size=151936, seq_len=131072, head_dim=128, shared_classifier=False,
        group_size=64,
    ),
}
