"""The sparse-expert configuration's files: a tiny expert cell through the
harness on the CPU as files (its model module models/qwen3_moe.py and its
reference reference/qwen3_moe.py), the experts' and routing's work counts
at Qwen3-30B-A3B's sizes worked by hand, and the benchmark's reference
against the repository's own plain reference (tests/plain_qwen3_moe.py)
and against the port's CPU path."""

import io
import json
import time
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

import tiny
from cudabench.core import bench
from cudabench.core.spec import load_module
from cudabench.metrics import _roofline as rl

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MOE = tiny.model("qwen3_moe")

# a tiny qwen3_moe: 8 experts of 64, top 2, 8 query heads over 1 kv head
# (qwen3-30b-a3b's query group), untied as published
CONFIG = {**tiny.CONFIG, "model_type": "qwen3_moe", "intermediate_size": 512,
          "num_attention_heads": 8, "num_key_value_heads": 1,
          "tie_word_embeddings": False, "num_experts": 8,
          "num_experts_per_tok": 2, "moe_intermediate_size": 64,
          "norm_topk_prob": True, "decoder_sparse_step": 1,
          "mlp_only_layers": [], "model": "qwen3_moe",
          "reference": "qwen3_moe"}
NEW = ("expert_roofline", "route_roofline", "moe_host_ms")
# the tiny cell's limits: tiny.CELL's, but for the widest gaps. At 2 of 8
# experts a routing flip at a near tie (the program's bf16 activations
# against the reference's float32) moves half of a layer's MLP output, and
# with it a greedy token's logit by up to ~0.5 and a sampled token's coin
# by up to ~0.1 of mass (the window's requests, and so the flips sampled,
# vary from run to run); the means still hold tiny.CELL's limits
MOE_CELL = {**tiny.CELL, "check": {**tiny.CELL["check"], "max_gap": 1.0,
                                   "max_coin_gap": 0.5}}


def run_cell(root, trace=0, seed=2**31 + 91, seconds=3):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--workload", "tiny", "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        t_start=time.perf_counter(), root=root,
                        device="cpu", require_card=False)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and rc == 0 else None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("moe"), config=CONFIG,
                          cell=MOE_CELL)


def test_a_tiny_expert_cell_runs_from_its_files(root, monkeypatch):
    from qwen3_tpu_torch.utils.profiling import SPANS

    rc, res = run_cell(root)
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"tok_s", "setup_s"}
    assert res["checks"]["tokens"]["value"] >= 8
    # the span readers start the recorder from the command line, as run.py
    # gives it
    monkeypatch.setattr("sys.argv", ["run.py", "--trace", "1"])
    try:
        rc, res = run_cell(root, trace=1, seconds=4)
    finally:
        SPANS.stop()
    assert rc == 0 and res["correct"] is True, res["checks"]
    # the program's span is read; the CPU has no device trace, so the
    # rooflines read nothing (never 0)
    assert res["metrics"]["moe_host_ms"]["value"] > 0
    assert "expert_roofline" not in res["metrics"]
    assert "route_roofline" not in res["metrics"]


def test_the_new_metrics_are_the_new_cells_alone():
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench_json["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == ["30b-a3b-chat-c64"]
            assert m["moves"] == "tok_s"
    cell = next(w for w in bench_json["workloads"]
                if w["name"] == "30b-a3b-chat-c64")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "qwen3-30b-a3b", "chat", 1)
    kernels = [k for f in MOE.FAMILIES.values() for k in f.kernels]
    assert len(kernels) == len(set(kernels))
    assert set(MOE.FAMILIES) == {"matmul", "attention", "experts", "routing"}


def test_the_hand_over_keeps_no_expert_on_the_host():
    s = MOE.sizes_of(CONFIG)
    cpu = torch.device("cpu")
    w = MOE.make(s, 3, CONFIG["weights"], cpu)
    lists = {k: w[k] for k in ("we1_q", "we2_s", "we3_q")}
    assert all(len(v) == s["n_layers"] for v in lists.values())
    cfg, params = MOE.to_port(w, s, 128, "pallas-fast", cpu)
    assert w == {} and cfg.n_experts == 8
    # the port packed each layer and let go of the lists' tensors
    assert all(t is None for v in lists.values() for t in v)
    assert params["we13_q"][0].shape == (8, 128, 128)


SIZES = MOE.sizes_of(json.loads(
    (BENCH / "configs" / "qwen3-30b-a3b.json").read_text()))
# one layer's experts: w13 2048 x 1536 int8 + 4 x 1536 x 32 scales =
# 3,342,336 bytes, w2 768 x 2048 + 4 x 2048 x 12 = 1,671,168; x 128
EXPERT_LAYER = 128 * (3_342_336 + 1_671_168)
# a row's bytes a layer: its f32 input 8,192, and for each of its 8 pairs
# the bf16 swiglu written and read (2 x 1,536) and the f32 output 8,192
EXPERT_ROW = 8_192 + 8 * (1_536 + 1_536 + 8_192)
# 2 x 3 x 2048 x 768 x 8 x 48 a token
EXPERT_TOKEN = 3_623_878_656


def test_expert_work_of_one_30b_decode_step():
    assert EXPERT_LAYER == 641_728_512 and EXPERT_ROW == 98_304
    flops, nbytes = MOE.FAMILIES["experts"].work(
        SIZES, list(range(100, 164)), [], 1, 0)
    assert flops == 64 * EXPERT_TOKEN
    assert nbytes == 48 * EXPERT_LAYER + 64 * 48 * EXPERT_ROW
    # the weights' 30.8 GB bound it: 9.3 ms at 3.35 TB/s
    assert rl.least_seconds(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)
    assert 9.2e-3 < nbytes / 3.35e12 < 9.4e-3


def test_expert_work_of_a_1024_row_block():
    flops, nbytes = MOE.FAMILIES["experts"].work(
        SIZES, [], [512, 256, 256], 0, 1)
    assert flops == 1024 * EXPERT_TOKEN
    assert nbytes == 48 * EXPERT_LAYER + 1024 * 48 * EXPERT_ROW
    # 3.71 TFLOP at 989 TFLOP/s: 3.75 ms, above the weights' 9.3 ms? no:
    # the bytes still bound it at 1024 rows
    assert rl.least_seconds(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)


def test_routing_work():
    # the router: 2048 x 128 int8 + 4 x 128 x 32 scales a layer; a row's
    # f32 input, its 8 ids and weights, the index's read and write of its
    # 8 entries, the combine's read of 8 f32 outputs (65,536) and 8
    # weights and its f32 row
    w_layer = 262_144 + 16_384
    row = 8_192 + 64 + 32 + 32 + 65_536 + 32 + 8_192
    flops, nbytes = MOE.FAMILIES["routing"].work(
        SIZES, list(range(64)), [], 1, 0)
    assert flops == 64 * 2 * 2048 * 128 * 48
    assert nbytes == 48 * w_layer + 64 * 48 * row
    assert MOE.FAMILIES["routing"].flops(SIZES, list(range(64)), [100]) \
        == 164 * 2 * 2048 * 128 * 48


def test_matmul_work_has_no_dense_mlp():
    flops, _ = MOE.FAMILIES["matmul"].work(SIZES, list(range(64)), [], 1, 0)
    # q, k, v, o: 2048 x (4096 + 2 x 512) + 4096 x 2048 a layer, and the
    # classifier 2048 x 151936
    per_token = 48 * (2048 * 5120 + 4096 * 2048) + 2048 * 151936
    assert flops == 2 * per_token * 64


def test_readers_of_the_new_families():
    mod = {n: load_module(BENCH / "metrics" / f"{n}.py", n)
           for n in ("expert_roofline", "route_roofline")}
    trace = types.SimpleNamespace(
        bursts=(0, 1), steps=1, forwards=0, window_s=0.1, busy_s=0.05,
        seconds=lambda names: (0.02 if "q8_fast_group_kernel" in names
                               else 0.001))
    run = types.SimpleNamespace(model=MOE, sizes=SIZES, trace=trace,
                                positions=lambda lo, hi: list(range(64)),
                                admitted=lambda lo, hi: [])
    got = mod["expert_roofline"].read(run)
    want = 100 * rl.least_seconds(*MOE.FAMILIES["experts"].work(
        SIZES, list(range(64)), [], 1, 0)) / 0.02
    assert got == pytest.approx(want) and 0 < got < 100
    assert 0 < mod["route_roofline"].read(run) < 100
    dense = types.SimpleNamespace(**{**vars(run), "model": tiny.model()})
    assert mod["expert_roofline"].read(dense) is None


def _span(name, start, end, parent):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 parent=parent)


def test_moe_host_ms_sums_the_spans_under_each_step(monkeypatch):
    reader = load_module(BENCH / "metrics" / "moe_host_ms.py", "moe_host")
    sp = [_span("chunk", 0, 100, None), _span("step", 10, 40, 0),
          _span("step.enqueue", 10, 30, 1), _span("moe", 12, 14, 2),
          _span("moe", 20, 23, 2), _span("step", 50, 90, 0),
          _span("step.enqueue", 50, 80, 5), _span("moe", 60, 66, 6),
          _span("prefill.block", 91, 99, None), _span("moe", 92, 98, 8)]
    sp = [types.SimpleNamespace(**vars(s)) for s in sp]
    for s in sp:   # ns -> the reader's units: ms x 1e6
        s.start, s.end = s.start * 1_000_000, s.end * 1_000_000
    monkeypatch.setattr(reader._spans, "spans", lambda: sp)
    monkeypatch.setattr(reader._spans, "window_ns", lambda run: (0, 1e9))
    assert reader.read(None) == pytest.approx((5 + 6) / 2)
    monkeypatch.setattr(reader._spans, "spans", lambda: None)
    assert reader.read(None) is None


def _plain_reference():
    return load_module(ROOT / "tests" / "plain_qwen3_moe.py", "plain_moe")


def test_the_two_references_give_the_same_logits():
    ref = load_module(BENCH / "reference" / "qwen3_moe.py", "ref_moe")
    plain = _plain_reference()
    s = MOE.sizes_of(CONFIG)
    cpu = torch.device("cpu")
    w = MOE.make(s, 7, CONFIG["weights"], cpu)
    cfg = MOE.model_config(s, 128)
    seq = [(5 * i + 33) % 250 for i in range(40)]
    cls = ref.dequant(w["cls_q"], w["cls_s"], s["group_size"])
    got = ref.rmsnorm(ref.hidden(w, s, [seq], cpu)[0], w["out_norm"],
                      s["rms_eps"]) @ cls.T
    want = plain.logits(types.SimpleNamespace(**w), cfg, seq)
    # both float32 over the same dequantized weights, in another order of
    # sums
    assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_the_reference_against_the_port():
    from qwen3_tpu_torch.models.qwen3 import forward, init_kv_cache

    ref = load_module(BENCH / "reference" / "qwen3_moe.py", "ref_moe2")
    s = MOE.sizes_of(CONFIG)
    cpu = torch.device("cpu")
    seq = [(7 * i + 40) % 250 for i in range(60)]
    w = MOE.make(s, 5, CONFIG["weights"], cpu)
    cls = ref.dequant(w["cls_q"], w["cls_s"], s["group_size"])
    want = ref.rmsnorm(ref.hidden(w, s, [seq], cpu)[0], w["out_norm"],
                       s["rms_eps"]) @ cls.T
    cfg, params = MOE.to_port(w, s, 128, "pallas-fast", cpu)
    k, v = init_kv_cache(cfg, 1, 128, "float32", cpu)
    got = forward(params, cfg, torch.tensor([seq]), k, v, 0,
                  mode="pallas-fast", all_logits=True)[0][0]
    # bf16 rounding, and the rare routing flip at a near tie: the median
    # position (tests/test_torch_moe.py's rule)
    err = ((got - want).abs().amax(-1) / want.std()).median()
    assert err < 0.06
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.9
