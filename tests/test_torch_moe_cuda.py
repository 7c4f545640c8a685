"""The sparse expert layer's kernels (ops/cuda/moe.py) against their plain
versions on the card, its launches and its reads back to the host.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py

Every kernel is bit-equal to its plain version: the router rounds each
product and sum in the plain order and takes PyTorch's expf and true
division; the grouped matmuls' products of bf16 values are exact in fp32
and sum in q8_fast_matmul_plain's order; the combine adds in slot order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.ops.cuda import moe  # noqa: E402

pytestmark = pytest.mark.cuda

# Qwen3-30B-A3B's widths: dim, expert width, group
DIM, WIDTH, G = 2048, 768, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _q8(rng, shape, g, dev, scale=0.02):
    q = rng.integers(-127, 128, size=shape).astype(np.int8)
    s = (scale / 127 * (0.5 + rng.random(shape[:-1] + (shape[-1] // g,))))
    return (torch.from_numpy(q).to(dev),
            torch.from_numpy(s.astype(np.float32)).to(dev))


def test_router_matches_plain_on_card(dev):
    """Logits, softmax, top 8 and weights at 300 rows over 128 experts,
    and at one row; every row's picks, weights and bf16 copy as the plain
    version's, and a row's bits the same alone as in the batch."""
    rng = np.random.default_rng(1)
    wq, ws = _q8(rng, (128, DIM), G, dev, scale=0.2)
    h = torch.from_numpy(rng.standard_normal((300, DIM)).astype(
        np.float32)).to(dev)
    moe.reset_launches()
    ids, w, hb = moe.route(h, wq, ws, 8, G)
    one = moe.route(h[17:18].contiguous(), wq, ws, 8, G)
    torch.cuda.synchronize()
    assert moe.LAUNCHES["route"] == 2
    want_ids, want_w, want_hb = moe.route_plain(h, wq, ws, 8, G)
    assert torch.equal(ids, want_ids)
    assert torch.equal(w, want_w)
    assert torch.equal(hb, want_hb)
    assert torch.equal(one[0], ids[17:18]) and torch.equal(one[1], w[17:18])
    assert (w[:, :-1] >= w[:, 1:]).all()


@pytest.mark.parametrize("rows", [0, 1, 4, 17, 64, 300, 1024])
def test_grouped_matmuls_match_plain_on_card(dev, rows):
    """The index, the grouped w13 with its swiglu and the grouped w2 at
    `rows` pairs of expert 0, expert 1 with none, at Qwen3-30B-A3B's
    widths; bit for bit, one launch each."""
    rng = np.random.default_rng(rows)
    E, K = 4, 2
    N = max(rows, 8)
    ids = np.empty((N, K), np.int32)
    ids[:, 0] = np.where(np.arange(N) < rows, 0, 2)
    ids[:, 1] = 3
    ids = torch.from_numpy(ids).to(dev)
    w13_q, w13_s = _q8(rng, (E, 2 * WIDTH, DIM), G, dev)
    w2_q, w2_s = _q8(rng, (E, DIM, WIDTH), G, dev)
    h = torch.from_numpy(rng.standard_normal((N, DIM)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    stats = torch.zeros(E, dtype=torch.int64, device=dev)
    moe.reset_launches()
    lst, cnt = moe.index(ids, E, stats)
    act = moe.experts(h, lst, cnt, w13_q, w13_s, G, K, True, N * K)
    y = moe.experts(act, lst, cnt, w2_q, w2_s, G, 1, False, N * K)
    torch.cuda.synchronize()
    assert moe.LAUNCHES == {"route": 0, "index": 1, "w13": 1, "w2": 1,
                            "combine": 0}
    want_l, want_c = moe.index_plain(ids, E)
    assert torch.equal(cnt, want_c)
    assert cnt.tolist() == [rows, 0, N - rows, N]
    assert stats.tolist() == [rows, 0, N - rows, N]
    for e, c in enumerate(cnt.tolist()):
        assert torch.equal(lst[e, :c], want_l[e, :c])
    want_act = moe.experts_plain(h, want_l, want_c, w13_q, w13_s, G, K, True)
    assert torch.equal(act, want_act)
    want_y = moe.experts_plain(act, want_l, want_c, w2_q, w2_s, G, 1, False)
    assert torch.equal(y, want_y)


def test_combine_matches_plain_on_card(dev):
    rng = np.random.default_rng(7)
    for N in (1, 64, 1024):
        y = torch.from_numpy(rng.standard_normal((N * 8, DIM)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.random((N, 8)).astype(np.float32)).to(dev)
        got = moe.combine(y, w)
        torch.cuda.synchronize()
        assert torch.equal(got, moe.combine_plain(y, w))


def _model(preset, dev, layers=None, vocab=None):
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.synthetic import synthetic_weights
    from qwen3_tpu_torch.models import qwen3 as model

    cfg = PRESETS[preset]
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers, vocab_size=vocab,
                                  seq_len=256)
    params = model.init_params(synthetic_weights(cfg, seed=5, scale=0.1),
                               mode="pallas-fast", max_seq_len=256,
                               device=dev)
    return cfg, params


def _step(model, cfg, params, dev, B, pos0):
    """One serving decode step (the side buffer, the batched decode
    kernel), every input already on the card."""
    from qwen3_tpu_torch.runtime.kvcache import make_side

    k, v = model.init_kv_cache(cfg, B, 256, "int8", dev)
    toks = torch.arange(B, device=dev) % cfg.vocab_size
    base = torch.full((B,), pos0, dtype=torch.int64, device=dev)
    sk, sv = make_side(k, 8), make_side(v, 8)
    return lambda: model.decode_forward(
        params, cfg, toks, k, v, base, mode="pallas-fast", attn="fused",
        side=(sk, sv, base, 0), live=pos0, attn_bucket=256)


@pytest.mark.parametrize("preset", ["tiny-moe", "qwen3-30b-a3b"])
def test_expert_step_launches_and_reads_nothing_back(dev, preset):
    """A 64-slot decode step and a prefill block: five expert-layer
    launches a layer (LAUNCHES), the counters' rows, the per-expert counts
    summing to them, and no synchronizing call inside either
    (set_sync_debug_mode("error")). qwen3-30b-a3b at its widths, 2 layers
    and a small vocabulary."""
    from qwen3_tpu_torch.models import qwen3 as model

    wide = preset == "qwen3-30b-a3b"
    cfg, params = _model(preset, dev, *((2, 4096) if wide else ()))
    step = _step(model, cfg, params, dev, 64, 40)
    blk = torch.arange(48, device=dev).reshape(1, 48) % cfg.vocab_size
    k, v = model.init_kv_cache(cfg, 1, 256, "int8", dev)
    step()
    model.forward(params, cfg, blk, k, v, 0, mode="pallas-fast")
    torch.cuda.synchronize()
    before = model.expert_counts(params).sum()
    rows0 = model.CALLS["moe_rows"]
    moe.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
        model.forward(params, cfg, blk, k, v, 0, mode="pallas-fast")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    L, K = cfg.n_layers, cfg.n_experts_per_tok
    assert moe.LAUNCHES == {key: 2 * L for key in moe.LAUNCHES}
    assert model.CALLS["moe_rows"] - rows0 == (64 + 48) * K * L
    assert model.expert_counts(params).sum() - before == (64 + 48) * K * L


def test_dense_step_launches_unchanged(dev):
    """A qwen3-4b-shaped step (2 layers, small vocabulary) launches what
    the dense path always has: four layer matmuls a layer and the
    classifier, the norm folds, one batched decode a layer, and no expert
    kernel."""
    from qwen3_tpu_torch.models import qwen3 as model
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd
    from qwen3_tpu_torch.ops.cuda import norms as cn
    from qwen3_tpu_torch.ops.cuda import q8_matmul as tq

    cfg, params = _model("qwen3-4b", dev, 2, 4096)
    step = _step(model, cfg, params, dev, 64, 40)
    step()
    torch.cuda.synchronize()
    for mod in (tq, cn, bd, moe):
        mod.reset_launches()
    step()
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked_fast"] == 8 and tq.LAUNCHES["tiled_fast"] == 1
    assert sum(tq.LAUNCHES[k] for k in tq.ROUTE_KEYS) == 9
    assert cn.LAUNCHES == {"rmsnorm": 2, "rms_inv": 0, "add_rmsnorm": 3,
                           "add_rms_inv": 0, "qk_norm_rope": 2}
    assert bd.LAUNCHES == {"batched_decode_partial": 2}
    assert all(n == 0 for n in moe.LAUNCHES.values())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_attention_kernels_at_a_query_group_of_eight(dev, dtype):
    """qwen3-30b-a3b's 32 query heads over 4 kv heads of 128, a group of 8
    that no dense preset has: flash decode, flash prefill (its query tile
    at 64 / 8 rows) and the batched decode kernel against their plain
    versions, by tests/test_torch_cuda.py's own checks."""
    import test_torch_cuda as card

    card.test_flash_decode_matches_plain_on_card(dev, dtype, 32, 4, 128)
    card.test_flash_prefill_matches_plain_on_card(dev, dtype, 32, 4, 128,
                                                  64, 64)
    for fast in (False, True):
        card.test_batched_decode_matches_plain_on_card(dev, dtype, fast, 32,
                                                       4, 128)
