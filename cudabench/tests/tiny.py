"""A throwaway cell at a size the CPU runs in seconds, written as files
into a copy of the benchmark: BENCHMARK.json names it, and its config,
mix and cell settings are files of their own, found by name; so can be
its model module and its reference (`tiny_w13`, a model with another
tensor set than the dense block's)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from cudabench.core.spec import load_module

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

CONFIG = {
    "name": "tiny-test", "source": "test-only",
    "model_type": "qwen3", "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 4096,
    "tie_word_embeddings": True, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000, "max_position_embeddings": 256,
    "rope_scaling": None, "reduced": [], "assumed": [],
    "quantization": {"format": "Q8_0", "group_size": 32},
    "weights": {"scale": 0.1},
    "engine": {"mode": "pallas-fast", "kv_dtype": "int8", "attn": "auto",
               "decode_chunk": 8, "prefill_bucket": 32, "top_k": 64,
               "max_batch": 4, "seq_len": 256},
    "model": "qwen3", "reference": "qwen3",
}

# the test-only model whose w1 and w3 are one stacked family: its module
# and its reference, as files of their own (models/, reference/)
W13_FILES = {"models/tiny_w13.py": HERE / "tiny_w13_model.py",
             "reference/tiny_w13.py": HERE / "tiny_w13_reference.py"}
W13_CONFIG = {**CONFIG, "model": "tiny_w13", "reference": "tiny_w13"}

MIX = {
    "why": "test-only", "clients": 4, "block": 4,
    "prompt_tokens": {"dist": "loguniform", "low": 8, "high": 40},
    "output_tokens": {"dist": "uniform", "low": 24, "high": 64},
    "temperature": 0.7, "top_p": 0.9,
    "greedy_share": 0.5,
    "prompt_bytes": {"low": 32, "high": 126, "except": "<"},
}

CELL = {"check": {"served_tokens": 64, "sampled_tokens": 64, "min_tokens": 8,
                  "max_gap": 0.05, "mean_gap": 0.01, "max_coin_gap": 0.05,
                  "mean_coin_gap": 0.01},
        "trace": {"chunks": 1}}


def model(name: str = "qwen3"):
    """The benchmark's model module `name` (models/<name>.py)."""
    return load_module(ROOT / "cudabench" / "models" / f"{name}.py",
                       f"tiny_model_{name}")


def make_root(tmp: Path, *, config=None, mix=None, cell=None,
              metrics: dict | None = None,
              files: dict | None = None) -> Path:
    """A copy of the benchmark under `tmp` whose BENCHMARK.json also
    lists the cell `tiny` (config `tiny-test`, mix `tiny-mix`);
    `metrics` maps further per-layer metric names to reader sources,
    `files` further new files of the benchmark (a path under it) to the
    files they copy. No file of the copy is changed: each is new."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "cudabench", root / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny", "config": "tiny-test",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "test-only"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny")
    for name, source in (metrics or {}).items():
        bench["per_layer"].append({
            "name": name, "unit": "n", "better": "higher",
            "source": "program_counter", "layer": "test", "moves": "tok_s",
            "workloads": ["tiny"]})
        (root / "cudabench" / "metrics" / f"{name}.py").write_text(source)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "cudabench"
    (b / "configs" / "tiny-test.json").write_text(json.dumps(config or CONFIG))
    (b / "traffic" / "tiny-mix.json").write_text(json.dumps(mix or MIX))
    (b / "cells" / "tiny.json").write_text(json.dumps(cell or CELL))
    for rel, src in (files or {}).items():
        if (b / rel).exists():
            raise FileExistsError(b / rel)
        shutil.copyfile(src, b / rel)
    return root
