"""The long-context path (`--attn flash`, and depth >= 8192 under
`--attn auto`) of the port's Engine, CLI and ChatSession against the JAX
package's, on the CPU (flash kernels: the port's plain versions, the JAX
package's Pallas kernels in interpret mode), on a `tiny` checkpoint whose
header allows 8448 positions.

A prompt of 8300 tokens prefills in blocks that start below and past 8192,
then 16 tokens decode at depth, so both packages switch from dense to flash
attention in prefill and decode. The two packages' fp32 ops differ in the
last ulp, and over 8300 rows some K/V values sit within an ulp of an int8
rounding boundary: the int8 cache then differs by one step in a few places,
and the logits by about 1e-3 of their max (ROADMAP.md, Queue C #1: the same
mechanism as the Q8 activation flips). Greedy picks stand far above that on
this checkpoint, so the depth test decodes greedily; the short CLI and chat
runs use prompts and seeds without such a flip."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from qwen3_tpu.cli import main as jax_main  # noqa: E402
from qwen3_tpu.config import PRESETS  # noqa: E402
from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.runtime.chat import ChatSession as JaxChat  # noqa: E402
from qwen3_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from qwen3_tpu.runtime.engine import EngineConfig as JaxConfig  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tm  # noqa: E402
from qwen3_tpu_torch.runtime.chat import ChatSession  # noqa: E402
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEQ = 8448
N_PROMPT = 8300
SENTENCE = ("Once upon a time there was a small town at the edge of a "
            "forest, and in the town there lived an old clockmaker and the "
            "children who came to watch him work. ")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = dataclasses.replace(PRESETS["tiny"], seq_len=SEQ)
    path = str(tmp_path_factory.mktemp("torch_long") / "tiny8448.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=1234))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


def _words(seed: int) -> str:
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    return " ".join("".join(rng.choice(letters, rng.integers(2, 8)))
                    for _ in range(2000))


def _kw(ckpt, seed, temperature, **extra):
    return dict(path=ckpt, seed=seed, temperature=temperature, top_p=0.9,
                mode="pallas", kv_dtype="int8", **extra)


@pytest.mark.parametrize("text", ["sentence", "words"])
def test_engine_crosses_8192_like_jax(ckpt, text):
    """attn="auto", int8 KV: an 8300-token prompt and 16 greedy tokens give
    the JAX engine's ids, through flash prefill blocks (those that start at
    8192 or later) and flash decode steps (every step: the depth is past
    8192 from the first)."""
    eng = Engine(EngineConfig(device="cpu", **_kw(ckpt, 42, 0.0)))
    raw = SENTENCE * 80 if text == "sentence" else _words(1)
    prompt = eng.tokenizer.decode(eng.tokenizer.encode(raw)[:N_PROMPT])
    before = dict(tm.CALLS)
    got = eng.generate(prompt, max_tokens=16)
    calls = {k: tm.CALLS[k] - before[k] for k in tm.CALLS}
    want = JaxEngine(JaxConfig(**_kw(ckpt, 42, 0.0))).generate(
        prompt, max_tokens=16)
    assert len(got.ids) == N_PROMPT + 16
    assert got.ids == want.ids
    assert got.text == want.text
    # blocks 512 x 16 start below 8192 (dense); 64-row blocks at 8192 and
    # 8256 (flash); the 17 decode steps (16 emitted, one that stops) flash
    assert calls["forward"] == 18 and calls["forward_flash"] == 2
    assert calls["decode_forward"] == calls["decode_forward_flash"] == 17


def test_cli_attn_flash_stdout_matches_jax(ckpt, capsysbinary):
    """--attn flash from position 0, at -c 64: prefill and decode both run
    the flash kernels."""
    args = [ckpt, "-m", "completion", "-i", "in the beginning", "-t", "0.8",
            "-s", "3", "-c", "64", "--attn", "flash", "--max-tokens", "16"]
    assert jax_main(args) == 0
    want = capsysbinary.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_tpu_torch.cli", *args, "--device",
         "cpu"], cwd=REPO, capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == want
    assert b"tok/s" in proc.stderr


def test_chat_attn_flash_matches_jax(ckpt):
    """Two turns with attn="flash" at seq_len 64: the first runs to the
    context limit, the second starts with the overflow reset."""
    kw = _kw(ckpt, 7, 0.8, seq_len=64, attn="flash")
    js = JaxChat(JaxEngine(JaxConfig(**kw)), system_prompt="be brief")
    ts = ChatSession(Engine(EngineConfig(device="cpu", **kw)),
                     system_prompt="be brief")
    before = dict(tm.CALLS)
    for turn in ("hello", "why?"):
        assert ts.send(turn) == js.send(turn)
        assert ts.pos == js.pos and ts.last_stop == js.last_stop
    assert tm.CALLS["forward_flash"] - before["forward_flash"] == \
        tm.CALLS["forward"] - before["forward"] > 0
    assert tm.CALLS["decode_forward_flash"] - before["decode_forward_flash"] \
        == tm.CALLS["decode_forward"] - before["decode_forward"] > 0
