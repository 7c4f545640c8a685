"""The control of `correct`: a lower precision in the program's place
must come out as not correct. On the card at each cell's own size (one
seed here; cudabench/control.py reads more), and on the CPU the same path
at the tiny stand-in's size, where the margins of a small random model
are too wide for either control to fail reliably: there it is run, not
judged."""

import pytest
import torch

import tiny
from cudabench.control import readings
from cudabench.core import bench, spec

ROOT = tiny.ROOT


def test_the_controls_run_on_the_cpu(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = spec.load_cell(root, "tiny")
    checks, read, _ = readings(cell, 5, 3, torch.device("cpu"),
                               ("pallas-int8", "reference-fp8"))
    assert set(read) == {"program", "pallas-int8", "reference-fp8"}
    assert checks["tokens"]["value"] >= 8
    assert checks["sampled_tokens"]["value"] >= 8
    for name in read:
        assert read[name]["max_gap"] >= read[name]["mean_gap"] >= 0
        assert read[name]["max_coin_gap"] >= read[name]["mean_coin_gap"] >= 0


# the control readings that set each cell's limits (PERF.md section 6):
# the program's own int8 path fails the greedy mean gap; the reference in
# float8 fails the widest gap and both coin gaps
FAILS = {w: [("pallas-int8", "mean_gap"), ("reference-fp8", "max_gap"),
             ("reference-fp8", "max_coin_gap"),
             ("reference-fp8", "mean_coin_gap")]
         for w in ("4b-chat-c64",)}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(FAILS))
def test_the_controls_fail_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(ROOT, workload)
    limits = cell.settings["check"]
    checks, read, _ = readings(cell, 2**31 + 101, 51, torch.device("cuda:0"),
                               ("pallas-int8", "reference-fp8"))
    assert bench.check.passed(checks), checks
    for mode, number in FAILS[workload]:
        assert read[mode][number] > limits[number], (mode, number, read)
