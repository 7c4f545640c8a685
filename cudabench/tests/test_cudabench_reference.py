"""The reference against the port's CPU path (its kernels' plain
versions) on the tiny stand-in. The reference itself imports nothing of
the port; this test does, to hold one against the other."""

import ast
from pathlib import Path

import pytest
import torch

import tiny
from cudabench.core import spec

BENCH = Path(__file__).resolve().parents[1]


MODEL = tiny.model()


def reference():
    return spec.load_module(BENCH / "reference" / "qwen3.py", "ref_qwen3")


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "torch", "math"}, (path, names)


@pytest.mark.parametrize("mode", ["bf16", "pallas-fast"])
def test_reference_logits_match_the_port(mode):
    from qwen3_tpu_torch.models.qwen3 import forward, init_kv_cache

    ref = reference()
    s = MODEL.sizes_of(tiny.CONFIG)
    cpu = torch.device("cpu")
    seq = [(7 * i + 40) % 250 for i in range(60)]
    w = MODEL.make(s, 5, tiny.CONFIG["weights"], cpu)
    cls = ref.dequant(w["cls_q"], w["cls_s"], s["group_size"])
    want = ref.rmsnorm(ref.hidden(w, s, [seq], cpu)[0], w["out_norm"],
                       s["rms_eps"]) @ cls.T
    cfg, params = MODEL.to_port(w, s, 128, mode, cpu)
    k, v = init_kv_cache(cfg, 1, 128, "float32", cpu)
    got = forward(params, cfg, torch.tensor([seq]), k, v, 0, mode=mode,
                  all_logits=True)[0][0]
    # the port rounds activations (and weights) to bf16, the reference
    # does not: a few percent of the logits' spread. A wrong rope, norm or
    # mask moves them by their whole spread.
    assert (got - want).abs().max() < 0.1 * want.std()
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.9


def test_gaps_are_zero_for_the_references_own_picks():
    ref = reference()
    s = MODEL.sizes_of(tiny.CONFIG)
    cpu = torch.device("cpu")
    w = MODEL.make(s, 6, tiny.CONFIG["weights"], cpu)
    seqs = [[65, 66, 67, 68], [70, 71], [72, 73, 74]]
    first = [1, 0, 2]
    draws = [None, None, (0.7, 0.9, 2**63 + 5)]
    top = ref.picks(w, s, seqs, first, [3, 2, 1], draws, cpu)
    other = [[(t + 1) % s["vocab_size"] for t in p] for p in top]
    got = ref.gaps(w, s, seqs, first, draws, {"top": top, "other": other},
                   cpu)
    assert all(float(g.abs().max()) == 0.0 for g in got["top"])
    assert all(float(g.min()) > 0.0 for g in got["other"])
    assert [len(g) for g in got["top"]] == [3, 2, 1]


def test_the_references_sampler_is_the_ports():
    from qwen3_tpu_torch.runtime.sampler import sample_tokens
    from qwen3_tpu_torch.runtime.xorshift import XorshiftRng

    ref = reference()
    seed = 2**63 + 2**31 + 11
    rng = XorshiftRng(seed)
    coins = [rng.next_float() for _ in range(64)]
    assert ref.coins(seed, 64) == coins
    g = torch.Generator().manual_seed(3)
    logits = 2.0 * torch.randn(64, 4096, generator=g)
    coin = torch.tensor(coins)
    for t, top_p in ((0.6, 0.95), (0.7, 0.8), (1.0, 0.2)):
        got = sample_tokens(logits, coin, t, top_p)
        assert torch.equal(ref.sample(logits, coin, t, top_p), got)
        assert float(ref.coin_gaps(logits, got, coin, t, top_p).max()) \
            < 1e-6
        # the same coins at another temperature, or another token, land
        # well outside the span of the token served
        assert float(ref.coin_gaps(logits, got, coin, 1.1 * t,
                                   top_p).mean()) > 1e-3
        assert float(ref.coin_gaps(logits, (got + 1) % 4096, coin, t,
                                   top_p).min()) > 0
