"""The port's end-to-end and depth tools on the CPU at the tiny preset:
qwen3_tpu_torch/tools/e2e_8b.py (generate, skip if present, read back,
serve; the record it writes; parse_serve_output on serve.py's own lines)
and qwen3_tpu_torch/tools/quality_depth.py (its key, its gate), each
through main(argv) in this process, as tests/test_e2e_tool.py does for the
JAX package's tools."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import load_checkpoint  # noqa: E402
from qwen3_tpu_torch.tools import e2e_8b, quality_depth  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _run_e2e(tmp_path, capsys, *extra):
    rc = e2e_8b.main(["--preset", "tiny", "--cache-dir",
                      str(tmp_path / "cache"), "--out",
                      str(tmp_path / "e2e.json"), "--ctx", "128",
                      "--max-tokens", "12", "--device", "cpu", *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(line)


@pytest.fixture
def short_prompt(monkeypatch):
    """A prompt that leaves tiny's 128 positions room to generate (the
    JAX tool's prompt fills them)."""
    monkeypatch.setattr(e2e_8b, "PROMPT", "the thinker thought")


def test_stages_and_record(tmp_path, capsys, short_prompt):
    """Cold: generate (with the digest sidecar), read back, serve; the
    printed line is the record written to --out. Warm: the .bin is kept,
    its gen_s survives from the record, the other stages run again."""
    rc, got = _run_e2e(tmp_path, capsys)
    assert rc == 0 and got["ok"]
    assert got == json.loads((tmp_path / "e2e.json").read_text())
    ckpt = tmp_path / "cache" / "tiny.bin"
    assert ckpt.exists() and Path(str(ckpt) + ".tokenizer").exists()
    assert Path(str(ckpt) + ".digest.json").exists()
    assert got["preset"] == "tiny" and got["gen_s"] is not None
    assert "pack_s" not in got
    rb = got["readback"]
    assert rb["size_ok"] and rb["digests_ok"]
    assert rb["bytes"] == rb["header_bytes"] == ckpt.stat().st_size
    assert rb["tensors"] == ["cls_q", "cls_s", "w2_q[-1]", "w2_s[-1]"]
    serve = got["serve"]
    assert serve["rc"] == 0 and 0 < serve["n_tokens"] <= 12
    assert (serve["qmode"], serve["attn"], serve["kv_dtype"]) == (
        "pallas", "flash", "int8")
    assert serve["peak_device_gb"] is None          # the CPU has none
    for key in ("engine_ready_s", "prompt_ms", "generate_ms", "agg_tok_s",
                "steady_tok_s", "wall_s"):
        assert serve[key] is not None, key
    mtime = ckpt.stat().st_mtime_ns
    rc, again = _run_e2e(tmp_path, capsys)
    assert rc == 0 and again["ok"]
    assert ckpt.stat().st_mtime_ns == mtime         # not regenerated
    assert again["gen_s"] == got["gen_s"]
    untimed = [{k: json.loads(r["serve"]["stdout"])[k]
                for k in ("prompt", "text", "n_tokens")} for r in (got, again)]
    assert untimed[0] == untimed[1]


def test_found_bin_without_record(tmp_path, capsys, short_prompt):
    """A .bin found with no earlier record: gen_s is null, as in the JAX
    tool; without its sidecar the digests are not judged."""
    _run_e2e(tmp_path, capsys)
    (tmp_path / "e2e.json").unlink()
    Path(str(tmp_path / "cache" / "tiny.bin") + ".digest.json").unlink()
    rc, got = _run_e2e(tmp_path, capsys)
    assert rc == 0 and got["gen_s"] is None
    assert got["readback"]["digests_ok"] is None


def test_readback_finds_a_changed_tensor(tmp_path, capsys, short_prompt):
    """A byte changed in the last layer's w2 fails the readback (rc 1);
    the size check holds the file to the header's arithmetic."""
    _run_e2e(tmp_path, capsys)
    ckpt = tmp_path / "cache" / "tiny.bin"
    w = load_checkpoint(str(ckpt))
    cfg = w.config
    # the last layer's w2 values lie just before its scales and w3
    w3_bytes = cfg.n_layers * cfg.hidden_dim * cfg.dim * (
        1 + 4 / cfg.group_size)
    w2_last = cfg.dim * cfg.hidden_dim * (1 + 4 / cfg.group_size)
    at = ckpt.stat().st_size - int(w3_bytes) - int(w2_last)
    raw = bytearray(ckpt.read_bytes())
    assert np.int8(raw[at] - 256 if raw[at] > 127 else raw[at]) == \
        w.w2_q[-1].reshape(-1)[0]
    del w
    raw[at] ^= 1
    ckpt.write_bytes(bytes(raw))
    rc, got = _run_e2e(tmp_path, capsys)
    assert rc == 1 and not got["ok"]
    assert got["readback"]["size_ok"] and got["readback"]["digests_ok"] is False
    ckpt.write_bytes(bytes(raw) + b"\0")
    rc, got = _run_e2e(tmp_path, capsys)
    assert rc == 1 and not got["readback"]["size_ok"]


@pytest.mark.parametrize("preset", ["tiny", "tiny8", "qwen3-0.6b",
                                     "qwen3-4b", "deepseek-r1-qwen3-8b"])
def test_checkpoint_bytes(tmp_path, preset):
    """The header's arithmetic: the size the writer gives the small
    presets, and the 8B's 8.11 GiB (the JAX package's E2E_8B.json records
    the same file size) past 2^32 bytes."""
    cfg = PRESETS[preset]
    size = e2e_8b.checkpoint_bytes(cfg)
    if preset.startswith("tiny"):
        from qwen3_tpu_torch.io.checkpoint import write_checkpoint
        from qwen3_tpu_torch.io.synthetic import synthetic_weights

        path = tmp_path / "m.bin"
        write_checkpoint(str(path), synthetic_weights(cfg, seed=1))
        assert path.stat().st_size == size
    if preset == "deepseek-r1-qwen3-8b":
        record = json.loads((REPO / "E2E_8B.json").read_text())
        assert round(size / 2**30, 2) == record["bin_gib"]
        assert size > 2**32


def test_parse_serve_output_on_serve_lines(tmp_path, capsys):
    """parse_serve_output on the port's serve.py lines, as it prints them
    (a tiny checkpoint served in this process), and on canned lines in the
    same shapes; junk lines are skipped."""
    from qwen3_tpu_torch import serve
    from qwen3_tpu_torch.io.checkpoint import write_checkpoint
    from qwen3_tpu_torch.io.synthetic import (
        synthetic_tokenizer,
        synthetic_weights,
    )
    from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin

    cfg = PRESETS["tiny"]
    path = tmp_path / "m.bin"
    write_checkpoint(str(path), synthetic_weights(cfg, seed=2))
    write_tokenizer_bin(str(path) + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello there\n")
    assert serve.main(e2e_8b.serve_argv(path, 64, 9, "cpu", prompts)) == 0
    cap = capsys.readouterr()
    got = e2e_8b.parse_serve_output(cap.out, cap.err)
    rec = json.loads(cap.out.strip().splitlines()[-1])
    assert got["n_tokens"] == rec["n_tokens"] > 0
    assert got["prompt_ms"] == rec["prompt_ms"]
    assert got["generate_ms"] == rec["generate_ms"]
    assert "engine_ready_s" in got and "agg_tok_s" in got
    stderr = ("[Serve] engine ready in 42.5s (checkpoint load + device "
              "transfer; attn=flash, device=cuda)\n"
              "[Serve] 1 requests, 96 tokens in 2.35s (40.8 tok/s "
              "aggregate)\n")
    stdout = "garbage\n[1, 2]\n" + json.dumps(
        {"id": 0, "prompt": "p", "text": "t", "n_tokens": 96,
         "prompt_ms": 812.0, "generate_ms": 1530.0}) + "\n"
    got = e2e_8b.parse_serve_output(stdout, stderr)
    assert got["engine_ready_s"] == 42.5
    assert got["n_tokens"] == 96 and got["agg_tok_s"] == 40.8
    assert got["steady_tok_s"] == round(96 / 1.530, 2)
    assert e2e_8b.parse_serve_output("garbage\n", "") == {}


@pytest.fixture(scope="module")
def tiny_bin(tmp_path_factory):
    from qwen3_tpu_torch.io.checkpoint import write_checkpoint
    from qwen3_tpu_torch.io.synthetic import (
        synthetic_tokenizer,
        synthetic_weights,
    )
    from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin

    cfg = PRESETS["tiny"]
    path = tmp_path_factory.mktemp("depth") / "tiny-model.bin"
    write_checkpoint(str(path), synthetic_weights(cfg, seed=3))
    write_tokenizer_bin(str(path) + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


def test_quality_depth_writes_its_key(tiny_bin, tmp_path, capsys):
    """Two depths merge into one file under "<preset>@<ctx>" keys, each
    with exact, pallas and the int8-KV row; the file's other keys stay."""
    out = tmp_path / "quality.json"
    out.write_text(json.dumps({"metric": "delta_ppl", "tables": {
        "other@1": {"ctx": 1, "tokens": 1, "rows": {}, "pass": True}}}))
    for ctx in (64, 128):
        rc = quality_depth.main([str(tiny_bin), str(ctx), "--out", str(out),
                                 "--preset", "tiny", "--device", "cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and line == {"merged": f"tiny@{ctx}", "pass": True,
                                    "overall": True}
    q = json.loads(out.read_text())
    assert sorted(q["tables"]) == ["other@1", "tiny@128", "tiny@64"]
    assert q["pass"] is True
    table = q["tables"]["tiny@128"]
    assert table["ctx"] == 128 and table["pass"] is True
    assert sorted(table["rows"]) == ["exact", "pallas", "pallas+int8kv"]
    for row in table["rows"].values():
        assert abs(row["delta_ln"]) <= 0.005


def test_quality_depth_default_key_and_missing_file(tiny_bin, tmp_path,
                                                    capsys):
    """Without --preset the key is the file's stem; a missing checkpoint
    returns 2."""
    out = tmp_path / "q.json"
    assert quality_depth.main([str(tiny_bin), "64", "--out", str(out),
                               "--device", "cpu"]) == 0
    assert list(json.loads(out.read_text())["tables"]) == ["tiny-model@64"]
    assert quality_depth.main([str(tmp_path / "none.bin"), "64", "--out",
                               str(out), "--device", "cpu"]) == 2


def test_quality_depth_fails_on_a_missed_gate(tiny_bin, tmp_path, capsys,
                                              monkeypatch):
    """A mode whose ln ppl moves by 0.01 misses the 0.005 gate: rc 1, the
    table written with pass false, and the file's overall pass false."""
    import importlib

    # the module (the package exports a function of the same name)
    perplexity = importlib.import_module("qwen3_tpu_torch.eval.perplexity")
    real = perplexity.sequence_nll

    def nudged(params, cfg, ids, *, mode, **kw):
        nll = real(params, cfg, ids, mode=mode, **kw)
        return nll + 0.01 if mode == "pallas" else nll

    monkeypatch.setattr(perplexity, "sequence_nll", nudged)
    out = tmp_path / "q.json"
    rc = quality_depth.main([str(tiny_bin), "64", "--out", str(out),
                             "--preset", "tiny", "--device", "cpu"])
    assert rc == 1
    q = json.loads(out.read_text())
    assert q["tables"]["tiny@64"]["pass"] is False and q["pass"] is False


def test_quality_depth_chunks_from_16384():
    """The table's argv: --chunk 128 from 16384, the int8-KV row on."""
    argv = quality_depth.table_argv("m.bin", 8192, "exact,pallas", "cuda")
    assert "--chunk" not in argv and "--no-int8-kv" not in argv
    argv = quality_depth.table_argv("m.bin", 16384, "exact,pallas", "cuda")
    assert argv[argv.index("--chunk") + 1] == "128"


def test_serve_stage_matches_jax_serve(tmp_path, capsys, monkeypatch):
    """The slice as a whole on the CPU: the tool's serve stage (serve.py
    --batch 1 --qmode pallas --kv-dtype int8 --attn flash, greedy) on the
    .bin its generate stage wrote prints the JAX package's serve.py records
    for the same flags and file (the two-segment flash kernel in interpret
    mode there, its plain version here). The prompt is one without a Q8
    rounding flip between the packages (tests/test_torch_serving.py)."""
    from qwen3_tpu.serve import main as jax_serve

    monkeypatch.setattr(e2e_8b, "PROMPT", "the cat")
    rc, got = _run_e2e(tmp_path, capsys)
    assert rc == 0
    mine = json.loads(got["serve"]["stdout"].strip().splitlines()[-1])
    ckpt = tmp_path / "cache" / "tiny.bin"
    argv = e2e_8b.serve_argv(ckpt, 128, 12, "cpu",
                             Path(str(ckpt) + ".prompt.txt"))
    argv = argv[:argv.index("--device")] + argv[argv.index("--prompts"):]
    assert jax_serve(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mine["n_tokens"] > 0
    assert ({k: mine[k] for k in ("prompt", "text", "n_tokens")}
            == {k: want[k] for k in ("prompt", "text", "n_tokens")})
