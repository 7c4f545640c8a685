"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The matmul kernels are bit-equal to their plain versions: the group dots are
exact integers and the fp32 scale-and-sum rounds every product and every sum
in the same order in both (see qwen3_tpu_torch/csrc/q8_matmul.cu). The flash
kernels sum in another order than theirs and are held to 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.ops.cuda import q8_matmul as tq  # noqa: E402
from qwen3_tpu_torch.ops.q8 import quantize_act  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, n, d, g, layers, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    wq = rng.integers(-127, 128, size=(layers, d, n)).astype(np.int8)
    ws = (0.02 / 127 * (0.5 + rng.random((layers, d, n // g)))).astype(
        np.float32)
    xq, xs = quantize_act(x.to(dev), g)
    return xq, xs, torch.from_numpy(wq).to(dev), torch.from_numpy(ws).to(dev)


@pytest.mark.parametrize("b", [1, 2, 33, 64, 130])
@pytest.mark.parametrize("n,g", [(128, 32), (1024, 64), (3072, 64),
                                 (640, 64)])
def test_kernel_matches_plain_on_card(dev, b, n, g):
    """Both kernels (b = 1 runs the GEMV, b > 1 the row-block kernel), bit
    for bit, with one launch counted per call."""
    xq, xs, wq, ws = _inputs(b + n, b, n, 200, g, 2, dev)
    tq.reset_launches()
    got = tq.q8_q8_matmul_stacked(xq, xs, wq, ws, 1, g)
    want = tq.q8q8_matmul_plain(xq, xs, wq[1], ws[1], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked"] == 1
    assert torch.equal(got, want)
    got = tq.q8_q8_matmul_tiled(xq, xs, wq[0], ws[0], g)
    want = tq.q8q8_matmul_plain(xq, xs, wq[0], ws[0], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["tiled"] == 1
    assert torch.equal(got, want)


def _flash_cache(seed, b, s, kv, d, dtype, dev):
    """(k, v, k_s, v_s) on the card from numpy; int8 with per-row scales."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        f = rng.standard_normal((b, s, kv, d)).astype(np.float32)
        if dtype == "int8":
            sc = (np.abs(f).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
            q = np.clip(np.round(f / sc[..., None]), -127, 127)
            out.append((torch.from_numpy(q.astype(np.int8)).to(dev),
                        torch.from_numpy(sc).to(dev)))
        else:
            out.append((torch.from_numpy(f).to(getattr(torch, dtype)).to(dev),
                        None))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _flash_close(got, want):
    """The flash tolerance of the JAX package's own tests, 2e-5, scaled by
    max(1, max|plain|): the kernels sum in another order than the plain
    versions (split tiles, fmaf)."""
    assert torch.isfinite(got).all()
    tol = 2e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 64), (16, 8, 128), (16, 2, 128)])
def test_flash_decode_matches_plain_on_card(dev, dtype, h, kv, d):
    """Slots at the tile edges (0, ts-1, ts, S-1 and between), with and
    without `live`, one launch counted per call."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s = 3, 512
    k, v, ks, vs = _flash_cache(h + d, b, s, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    for pos_set in ([0, 255, 256], [511, 5, 300]):
        pos = torch.tensor(pos_set, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q, k, v, pos, ks, vs)
        for live in (None, max(pos_set) + 1):
            fd.reset_launches()
            got = fd.flash_decode_gqa(q, k, v, pos, ks, vs, live=live)
            torch.cuda.synchronize()
            assert fd.LAUNCHES == {"flash_decode": 1, "flash_prefill": 0}
            _flash_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kv,d,t,block_t", [(4, 2, 64, 32, 16),
                                              (16, 8, 128, 64, 64),
                                              (8, 2, 128, 128, 64)])
def test_flash_prefill_matches_plain_on_card(dev, dtype, h, kv, d, t,
                                             block_t):
    """Blocks that start at 0, across a tile boundary and at the end of the
    cache; (8, 2) has 4 heads per kv head, so the kernel's query tile halves
    to 32 rows."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s = 2, 512
    k, v, ks, vs = _flash_cache(h + d + t, b, s, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (b, t, h, d)).astype(np.float32)).to(dev)
    for start in (0, 256 - t // 2, s - t):
        qpos = torch.arange(start, start + t, dtype=torch.int32, device=dev)
        want = fd.flash_prefill_plain(q, k, v, qpos, ks, vs, block_t=block_t)
        fd.reset_launches()
        got = fd.flash_prefill_gqa(q, k, v, qpos, ks, vs, block_t=block_t)
        torch.cuda.synchronize()
        assert fd.LAUNCHES == {"flash_decode": 0, "flash_prefill": 1}
        _flash_close(got, want)


def test_flash_refuses_what_the_kernel_does_not_take(dev):
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    k, v, ks, vs = _flash_cache(0, 1, 256, 2, 64, "int8", dev)
    q = torch.zeros(1, 4, 64, device=dev)
    pos = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="both scales"):
        fd.flash_decode_gqa(q, k, v, pos, ks, None)
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode_gqa(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v, pos, ks, vs)
    with pytest.raises(ValueError, match="on "):
        fd.flash_decode_gqa(q, k.cpu(), v, pos, ks, vs)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_forward_on_card_matches_cpu(dev, tmp_path, attn):
    """A `tiny` model's prefill and decode logits on the card against the
    same model on the CPU (plain versions): the matmul kernels are
    bit-equal to their plain versions; the other ops (rsqrt, exp, the
    attention) may differ by ulps between the devices, hence 1e-4."""
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.synthetic import synthetic_weights
    from qwen3_tpu_torch.models import qwen3 as model

    cfg = PRESETS["tiny"]
    w = synthetic_weights(cfg, seed=3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    outs = []
    for device in (dev, torch.device("cpu")):
        p = model.init_params(w, max_seq_len=64, device=device)
        k, v = model.init_kv_cache(cfg, 1, 64, "int8", device)
        pre, k, v = model.forward(p, cfg, torch.from_numpy(toks).to(device),
                                  k, v, 0, all_logits=True, attn=attn)
        dec, k, v = model.decode_forward(
            p, cfg, torch.tensor([7], device=device), k, v,
            torch.tensor([16], device=device), attn=attn)
        outs.append((pre.cpu(), dec.cpu()))
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_sampler_scan_repeats_on_card(dev):
    """The sampler's prefix sum on the card gives the same bits on every
    call (torch.cumsum on a CUDA float tensor need not), and agrees with the
    CPU's sequential sum to float32 rounding."""
    from qwen3_tpu_torch.runtime.sampler import cumsum_last

    rng = np.random.default_rng(5)
    p = rng.random((1, 151936)).astype(np.float32)
    x = torch.from_numpy(p / p.sum())
    first = cumsum_last(x.to(dev))
    for _ in range(20):
        assert torch.equal(cumsum_last(x.to(dev)), first)
    assert (first.cpu() - torch.cumsum(x, dim=-1)).abs().max() <= 1e-6


def test_sample_tokens_on_card_match_cpu(dev):
    """sample_tokens on the card against its CPU run at vocabulary 151936:
    the top-64 fast path, the full scan, and the healed mass with its
    fallback index (chip_smoke.check_sampler states the cases and the
    bound)."""
    import chip_smoke

    report = chip_smoke.check_sampler(torch)
    assert report["top-64 fast path"] == 0
    assert report["healed mass, top-64"] == 0
    assert report["healed mass, full scan"] == 0
