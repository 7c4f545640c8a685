"""The port's Engine, ChatSession and CLI against the JAX package's on a
tiny synthetic checkpoint (mode "pallas", int8 KV, decode_impl "slot"): the
same token streams and the same stdout.

The prompts and seeds are ones where no Q8 activation rounding flips
between the packages (see test_torch_forward.py); "the cat in the hat" on
this checkpoint has one in its prefill, and some of its seeded streams
diverge (ROADMAP.md, Queue C)."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from qwen3_tpu.cli import main as jax_main  # noqa: E402
from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.runtime.chat import ChatSession as JaxChat  # noqa: E402
from qwen3_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from qwen3_tpu.runtime.engine import EngineConfig as JaxConfig  # noqa: E402
from qwen3_tpu_torch.runtime.chat import ChatSession  # noqa: E402
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PROMPT = "in the beginning"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, tiny_weights, tiny_tok):
    d = tmp_path_factory.mktemp("torch_engine")
    path = str(d / "tiny.bin")
    write_checkpoint(path, tiny_weights)
    write_tokenizer_bin(path + ".tokenizer", tiny_tok)
    return path


def _kw(ckpt, seed, temperature, **extra):
    return dict(path=ckpt, seed=seed, temperature=temperature, top_p=0.9,
                mode="pallas", kv_dtype="int8", **extra)


@pytest.mark.parametrize("seed,temperature", [(42, 0.0), (1, 0.8),
                                              (2, 0.8), (3, 0.8)])
def test_completion_stream_matches_jax(ckpt, seed, temperature):
    want = JaxEngine(JaxConfig(**_kw(ckpt, seed, temperature))).generate(
        PROMPT, max_tokens=24)
    got = Engine(EngineConfig(device="cpu",
                              **_kw(ckpt, seed, temperature))).generate(
        PROMPT, max_tokens=24)
    assert got.ids == want.ids
    assert got.text == want.text
    assert got.n_generated == want.n_generated


def test_chat_stream_matches_jax(ckpt):
    """Two turns at seq_len 64: the first runs to the context limit
    (emit_at_limit), the second starts with the overflow reset."""
    kw = _kw(ckpt, 7, 0.8, seq_len=64)
    js = JaxChat(JaxEngine(JaxConfig(**kw)), system_prompt="be brief")
    ts = ChatSession(Engine(EngineConfig(device="cpu", **kw)),
                     system_prompt="be brief")
    for turn in ("hello", "why?"):
        assert ts.send(turn) == js.send(turn)
        assert ts.pos == js.pos and ts.last_stop == js.last_stop


def test_cli_stdout_matches_jax(ckpt, capsysbinary):
    args = [ckpt, "-m", "completion", "-i", PROMPT, "-t", "0.8", "-s", "3",
            "-c", "64", "--qmode", "pallas", "--max-tokens", "16"]
    assert jax_main(args) == 0
    want = capsysbinary.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_tpu_torch.cli", *args, "--device",
         "cpu"], cwd=REPO, capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == want
    assert b"[pp " in proc.stderr and b"tok/s" in proc.stderr


def test_cli_chat_runs_on_cpu(ckpt, capsysbinary, monkeypatch):
    import io

    from qwen3_tpu_torch.cli import main

    monkeypatch.setattr(sys, "stdin", io.StringIO("hi there\n\n"))
    assert main([ckpt, "-m", "chat", "-t", "0", "-s", "3", "-c", "128",
                 "-y", "sys", "--device", "cpu"]) == 0
    assert b"[t/ms" in capsysbinary.readouterr().err
