"""Percentiles over every sample, and the operations and bytes the
rooflines and the step's MFU count, against hand-worked values at both
configurations' shapes, through their model module."""

import json
import math
import types
from pathlib import Path

import pytest

import tiny
from cudabench.core import stats
from cudabench.core.spec import load_module
from cudabench.metrics import _roofline as rl

BENCH = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def model_of(name):
    return tiny.model(config(name)["model"])


def sizes(name):
    return model_of(name).sizes_of(config(name))


QWEN3 = model_of("qwen3-4b")


def test_percentile_takes_every_sample_and_missing_as_late():
    v = list(range(1, 201))
    assert stats.percentile(v, 0.95) == 190
    assert stats.beyond(200, 0.95) == 10
    assert stats.beyond(199, 0.95) == 9       # a p95 of 199 is not a tail
    assert stats.percentile(v[:190] + [math.inf] * 10, 0.95) == 190
    assert math.isinf(stats.percentile(v[:189] + [math.inf] * 11, 0.95))
    assert stats.percentile([], 0.95) is None
    assert stats.percentile([5.0], 0.95) == 5.0


@pytest.mark.parametrize("name, per_layer, cls", [
    ("deepseek-r1-qwen3-8b", 192_937_984, 622_329_856),
    ("qwen3-4b", 100_925_440, 388_956_160)])
def test_matmul_parameters(name, per_layer, cls):
    s = sizes(name)
    assert QWEN3.matmul_params(s) == (36 * per_layer, cls)


def test_matmul_work_of_one_8b_decode_step():
    s = sizes("deepseek-r1-qwen3-8b")
    flops, nbytes = QWEN3.matmul_work(s, decode_tokens=64, steps=1,
                                      prompt_tokens=0, admitted=0,
                                      forwards=0)
    assert flops == 2 * 7_568_097_280 * 64
    # 8,041,103,360 bytes of Q8_0 weights and scales, then per token
    # 36 x 204,800 bytes of layer activations and 615,936 of the
    # classifier's
    assert nbytes == 8_041_103_360 + 64 * (7_372_800 + 615_936)
    assert rl.least_seconds(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)


def test_matmul_work_of_a_4b_prefill_block():
    s = sizes("qwen3-4b")
    flops, nbytes = QWEN3.matmul_work(s, decode_tokens=0, steps=0,
                                      prompt_tokens=1000, admitted=4,
                                      forwards=2)
    assert flops == 2 * 3_633_315_840 * 1000 + 2 * 388_956_160 * 4
    w = 36 * 100_925_440 * 17 // 16 + 388_956_160 * 17 // 16
    a_layer = 36 * (2 * (2560 + 4096 + 2560 + 9728)
                    + 4 * (6144 + 2560 + 19456 + 2560))
    a_cls = 2 * 2560 + 4 * 151936
    assert nbytes == 2 * w + 1000 * a_layer + 4 * a_cls
    assert rl.least_seconds(flops, nbytes) == pytest.approx(flops / 989e12)


def test_decode_attention_work():
    s = sizes("deepseek-r1-qwen3-8b")
    flops, nbytes = QWEN3.decode_attention_work(s, [0, 99])
    assert flops == 4 * 32 * 128 * 36 * 101
    assert nbytes == 36 * (101 * 2 * 8 * 132
                           + 2 * (2 * 32 * 128 + 4 * 32 * 130))
    assert QWEN3.prefill_attention_flops(s, [3]) == 4 * 32 * 128 * 36 * 6


def _run(s, positions, admitted, window_s, seconds=None, steps=1):
    trace = types.SimpleNamespace(
        bursts=(0, steps), steps=steps, forwards=len(admitted) > 0,
        window_s=window_s, busy_s=window_s / 2,
        seconds=lambda names: seconds or 0.0,
        kernels=lambda: 100)
    loop = types.SimpleNamespace(b0=0, b_end=steps, t0=1.0,
                                 t_end=1.0 + window_s)
    return types.SimpleNamespace(
        model=QWEN3, sizes=s, trace=trace, loop=loop,
        positions=lambda lo, hi: positions,
        admitted=lambda lo, hi: admitted)


def test_readers_of_the_trace():
    s = sizes("deepseek-r1-qwen3-8b")
    mod = {n: load_module(BENCH / "metrics" / f"{n}.py", n) for n in (
        "step_mfu", "matmul_roofline", "attn_roofline", "idle_share",
        "kernels_per_step")}
    run = _run(s, list(range(64)), [], window_s=0.1, seconds=0.05)
    mfu = mod["step_mfu"].read(run)
    want = (2 * 7_568_097_280 * 64
            + QWEN3.decode_attention_work(s, list(range(64)))[0])
    assert mfu == pytest.approx(100 * want / (0.1 * 989e12))
    mm = mod["matmul_roofline"].read(run)
    assert mm == pytest.approx(100 * rl.least_seconds(
        *QWEN3.matmul_work(s, 64, 1, 0, 0, 0)) / 0.05)
    assert 0 < mm < 100
    assert mod["attn_roofline"].read(run) == pytest.approx(
        100 * rl.least_seconds(*QWEN3.decode_attention_work(
            s, list(range(64)))) / 0.05)
    assert mod["idle_share"].read(run) == pytest.approx(50.0)
    assert mod["kernels_per_step"].read(run) == 100
    # nothing to read: no metric, never a 0 share
    empty = _run(s, [], [], window_s=0.1, seconds=0.0)
    for name in ("step_mfu", "matmul_roofline", "attn_roofline"):
        assert mod[name].read(empty) is None
    assert mod["step_mfu"].read(types.SimpleNamespace(
        loop=types.SimpleNamespace(b_end=None))) is None


# the readings of the harness before the counts moved into the model
# module, on one sub-window of decode and prefill, digit for digit
@pytest.mark.parametrize("name, want", [
    ("qwen3-4b", {"step_mfu": 0.6759961824265318,
                  "matmul_roofline": 1.430900356967164,
                  "attn_roofline": 0.4293621607164179}),
    ("deepseek-r1-qwen3-8b", {"step_mfu": 1.2710669641046715,
                              "matmul_roofline": 2.5039310664597014,
                              "attn_roofline": 0.4293621607164179})])
def test_readers_read_as_before(name, want):
    positions = [64 + 3 * i for i in range(200)] + list(range(1000, 1064))
    admitted = [64, 333, 1024, 517]
    trace = types.SimpleNamespace(
        bursts=(0, 8), steps=8, forwards=3, window_s=2.0, busy_s=1.5,
        seconds=lambda names: 0.75 if "decode_kernel" in names else 1.25)
    run = types.SimpleNamespace(
        model=model_of(name), sizes=sizes(name), trace=trace,
        loop=types.SimpleNamespace(b0=0, b_end=8, t0=1.0, t_end=3.5),
        positions=lambda lo, hi: positions,
        admitted=lambda lo, hi: admitted)
    got = {n: load_module(BENCH / "metrics" / f"{n}.py", n).read(run)
           for n in want}
    assert got == want
