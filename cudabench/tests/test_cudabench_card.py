"""The tiny stand-in cell on the card (its CUDA kernels have no CPU
mode), and the harness's own parts there: the card's weights from the
seed, the trace's readers, and a run's result line. Marked `cuda`: they
skip without a card (the check is made inside each test)."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

import tiny
from cudabench.core import bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_weights_on_the_card_follow_the_seed(card):
    model = tiny.model()
    s = model.sizes_of(tiny.CONFIG)
    a = model.make(s, 2**31 + 9, tiny.CONFIG["weights"], card)
    b = model.make(s, 2**31 + 9, tiny.CONFIG["weights"], card)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["wq_q"].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_cell_on_the_card(card, tmp_path, trace):
    root = tiny.make_root(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--workload", "tiny", "--seed", "2147483659",
                         "--seconds", "3", "--trace", str(trace)],
                        t_start=time.perf_counter(), root=root)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        m = res["metrics"]
        assert 0 < m["matmul_roofline"]["value"] < 100
        assert 0 < m["step_mfu"]["value"] < 100
        assert m["kernels_per_step"]["value"] > 0
        assert res["breakdown"]["device_ops"]
    else:
        assert res["metrics"]["tok_s"]["value"] > 0
