"""Whole runs of the tiny stand-in cell on the CPU, past the look for a
card: a cell, a model, a mix and a metric found by name as files; the
result line; the check for JAX; and the faults that must make `correct`
false."""

import io
import json
import re
import sys
import time
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

import tiny
from cudabench import faults
from cudabench.core import bench, check, spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

COUNTER = '''
def read(run):
    return float(len(run.records))
'''


def run_cell(root, *extra, trace=0, seed=77, seconds=3):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--workload", "tiny", "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace),
                         *extra],
                        t_start=time.perf_counter(), root=root,
                        device="cpu", require_card=False)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and rc == 0 else None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"),
                          metrics={"tiny_requests": COUNTER})


def test_harness_names_no_cell_model_mix_or_metric():
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = [json.loads((ROOT / c["file"]).read_text())
               for c in bench_json["configs"]]
    models = [tiny.model(c["model"]) for c in configs]
    names = ({w["name"] for w in bench_json["workloads"]}
             | {w["config"] for w in bench_json["workloads"]}
             | {w["traffic"] for w in bench_json["workloads"]}
             | {m["name"] for m in bench_json["per_layer"]}
             | {c[key] for c in configs for key in ("model", "reference")}
             | {k for m in models for f in m.FAMILIES.values()
                for k in f.kernels})
    code = ([BENCH / "run.py", BENCH / "control.py"]
            + sorted((BENCH / "core").glob("*.py"))
            + sorted((BENCH / "metrics").glob("_*.py")))
    for path in code:
        text = path.read_text()
        for name in names:
            assert not re.search(rf"\b{re.escape(name)}\b", text), \
                (path.name, name)


def test_a_throwaway_cell_runs_from_its_files(root):
    rc, res = run_cell(root)
    assert rc == 0
    assert res["correct"] is True
    assert set(res["metrics"]) == {"tok_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert res["device"]["count"] == 1


def test_a_throwaway_metric_is_read_in_the_traced_run(root):
    rc, res = run_cell(root, trace=1, seconds=4)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["tiny_requests"]["value"] >= 4
    for name in ("slot_occupancy", "ttft_p95_ms", "prefill_ms_p50"):
        assert res["metrics"][name]["value"] > 0
    assert "tok_s" not in res["metrics"]
    # the CPU has no device trace: its readers return nothing, never 0
    assert "matmul_roofline" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_throwaway_model_runs_from_its_files(tmp_path):
    """A model with another tensor set (w1 and w3 as one family), added
    as a model module, a reference and entries alone."""
    root = tiny.make_root(tmp_path, config=tiny.W13_CONFIG,
                          files=tiny.W13_FILES)
    rc, res = run_cell(root, seed=2**31 + 77)
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["tokens"]["value"] >= 8
    model = bench.model_of(spec.load_cell(root, "tiny"))
    w = model.make(model.sizes_of(tiny.W13_CONFIG), 1,
                   tiny.W13_CONFIG["weights"], torch.device("cpu"))
    assert "w13_q" in w and "w1_q" not in w and "w3_q" not in w


def test_an_unknown_workload_is_refused(root):
    rc, res = run_cell(root, "--workload", "nope")
    assert rc != 0 and res is None


def test_no_card_no_result(root, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = bench.main(["--workload", "tiny", "--seed", "1", "--seconds", "1"],
                    t_start=time.perf_counter(), root=root)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jax.numpy": 1, "qwen3_tpu.models": 1, "qwen3_tpu_torch": 1,
            "qwen3_tpu_torch.ops": 1, "jaxtyping": 1, "flax": 1}
    assert bench.forbidden_modules(mods) == ["flax", "jax", "qwen3_tpu"]
    assert bench.forbidden_modules({"qwen3_tpu_torch.x": 1}) == []


def test_a_run_that_loaded_jax_prints_no_result(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = run_cell(root)
    assert rc != 0 and res is None


def test_a_sound_run_loads_no_jax(root):
    import subprocess
    code = ("import sys, time; sys.path[:0] = [%r, %r]; import tiny; "
            "from pathlib import Path; from cudabench.core import bench; "
            "bench.main(['--workload', 'tiny', '--seed', '3', '--seconds', "
            "'1'], t_start=time.perf_counter(), root=Path(%r), "
            "device='cpu', require_card=False); "
            "print(bench.forbidden_modules())"
            % (str(ROOT), str(BENCH / "tests"), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- faults planted under the timed path: each must make `correct` false --


# the exchange between chips is no fault a one-chip cell can have
@pytest.mark.parametrize("fault", ["state", "half", "token",
                                   "temperature"])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch,
                                                      fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    rc, res = run_cell(root)
    assert rc == 0
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for name, c in res["checks"].items()
               if name in check.NUMBERS), res["checks"]


def test_a_planted_fault_is_undone():
    import qwen3_tpu_torch.runtime.decode_loop as dl
    orig = dl.sample_tokens
    with faults.planted("token"):
        assert dl.sample_tokens is not orig
    assert dl.sample_tokens is orig
