"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The matmul kernels are bit-equal to their plain versions: the group dots are
exact integers and the fp32 scale-and-sum rounds every product and every sum
in the same order in both (see qwen3_tpu_torch/csrc/q8_matmul.cu); the
pallas-fast kernel's products of bf16 values are exact in fp32 and it sums
in the plain version's order. The attention kernels sum in another order
than theirs and are held to 2e-5 (plus, under pallas-fast, the bf16
rounding of the value dot's operands, per element, see _value_tol).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.ops import norms as tq_norms  # noqa: E402
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


@pytest.mark.parametrize("b", [1, 2, 8, 9, 64, 130])
@pytest.mark.parametrize("n,g", [(128, 32), (1024, 64), (3072, 64)])
def test_fast_kernel_matches_plain_on_card(dev, b, n, g):
    """The pallas-fast kernels (b <= 8 runs the 8-row block, b > 8 the
    64-row block), bit for bit, with one launch counted per call."""
    rng = np.random.default_rng(b * 7 + n)
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(2, 200, n)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (2, 200, n // g)))).astype(np.float32)).to(dev)
    tq.reset_launches()
    got = tq.q8_matmul_stacked_fast(x, wq, ws, 1, g)
    want = tq.q8_fast_matmul_plain(x, wq[1], ws[1], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked_fast"] == 1
    assert torch.equal(got, want)
    got = tq.q8_matmul_tiled_fast(x, wq[0], ws[0], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["tiled_fast"] == 1
    assert torch.equal(got, tq.q8_fast_matmul_plain(x, wq[0], ws[0], g))


def test_fast_kernel_rows_do_not_depend_on_the_batch(dev):
    """Row r of a b = 64 call (the 64-row block) equals, bit for bit, the
    same row run alone (the 8-row block) and within b = 8."""
    rng = np.random.default_rng(1)
    n, d, g = 1024, 4096, 64
    x = torch.from_numpy(rng.standard_normal((64, n)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(d, n)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (d, n // g)))).astype(np.float32)).to(dev)
    full = tq.q8_matmul_tiled_fast(x, wq, ws, g)
    eight = tq.q8_matmul_tiled_fast(x[8:16].contiguous(), wq, ws, g)
    assert torch.equal(full[8:16], eight)
    for r in (0, 13, 63):
        alone = tq.q8_matmul_tiled_fast(x[r:r + 1].contiguous(), wq, ws, g)
        assert torch.equal(full[r:r + 1], alone)


def _weights(rng, layers, d, n, g, dev):
    wq = torch.from_numpy(rng.integers(-127, 128, size=(layers, d, n)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (layers, d, n // g)))).astype(np.float32)).to(dev)
    return wq, ws


@pytest.mark.parametrize("b", [1, 8, 9, 64, 130])
@pytest.mark.parametrize("n,g", [(128, 32), (512, 64), (768, 64),
                                 (3072, 64)])
def test_int8_kernel_matches_plain_on_card(dev, b, n, g):
    """The pallas-int8 kernels (one k-tile, the whole-axis fallback at 768,
    six tiles at 3072), bit for bit, one launch counted per call; a row's
    bits are the same alone and within the call."""
    rng = np.random.default_rng(b * 5 + n)
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(
        np.float32)).to(dev)
    wq, ws = _weights(rng, 2, 200, n, g, dev)
    tq.reset_launches()
    got = tq.q8i8_matmul_stacked(x, wq, ws, 1, g)
    want = tq.q8i8_matmul_plain(x, wq[1], ws[1], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["stacked_int8"] == 1
    assert torch.equal(got, want)
    got = tq.q8i8_matmul_tiled(x, wq[0], ws[0], g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["tiled_int8"] == 1
    assert torch.equal(got, tq.q8i8_matmul_plain(x, wq[0], ws[0], g))
    alone = tq.q8i8_matmul_tiled(x[b - 1:].contiguous(), wq[0], ws[0], g)
    assert torch.equal(got[b - 1:], alone)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("prologue", ["norm", "none", "swiglu"])
@pytest.mark.parametrize("b", [1, 8, 9, 64])
@pytest.mark.parametrize("n,g", [(128, 32), (1024, 64)])
def test_fused_kernel_matches_plain_on_card(dev, b, n, g, prologue, exact):
    """The prologue-fused kernel against its plain version (the port's
    unfused chain in plain ops) and against the unfused kernel on the plain
    prologue's output, bit for bit (the swiglu prologue's sigmoid is
    torch.sigmoid's formula and expf)."""
    rng = np.random.default_rng(b * 3 + n + exact)
    width = 2 * n if prologue == "swiglu" else n
    x = torch.from_numpy(rng.standard_normal((b, width)).astype(
        np.float32)).to(dev)
    nw = torch.from_numpy((1 + 0.1 * rng.standard_normal(n)).astype(
        np.float32)).to(dev)
    inv = tq_norms.rms_inv(x) if prologue == "norm" else None
    wq, ws = _weights(rng, 1, 200, n, g, dev)
    tq.reset_launches()
    got = tq.q8_matmul_fused(x, wq[0], ws[0], g, inv, nw, prologue=prologue,
                             exact=exact)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["fused"] == 1
    want = tq.q8_fused_matmul_plain(x, wq[0], ws[0], g, inv, nw,
                                    prologue=prologue, exact=exact)
    h = tq.fused_prologue(x, inv, nw, prologue)
    if exact:
        unfused = tq.q8_q8_matmul_tiled(*quantize_act(h, g), wq[0], ws[0], g)
    else:
        unfused = tq.q8_matmul_tiled_fast(h.to(torch.bfloat16), wq[0], ws[0],
                                          g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, unfused)


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
            assert fd.LAUNCHES == {"flash_decode": 1, "flash_prefill": 0,
                                   "flash_decode_two_segment": 0}
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
        assert fd.LAUNCHES == {"flash_decode": 0, "flash_prefill": 1,
                               "flash_decode_two_segment": 0}
        _flash_close(got, want)


def _value_tol(want, mag, fast):
    """Per element: 2e-5 * max(1, max|want|), plus under `fast` 2^-8 * mag,
    mag = sum_s p_s * |v_s * vs_s| (batched_decode_magnitude). The value
    dot's operand p * vs is rounded to bf16, by at most 2^-8 of itself; the
    kernel's p is relative to the running max of its own 64-row chunks, the
    plain version's to that of the Pallas kernel's tiles, so the two round
    each term independently (a gap of 2^-7 * mag would need every pair of
    roundings at opposite extremes)."""
    tol = 2e-5 * max(1.0, want.abs().max().item())
    return tol + 2.0 ** -8 * mag if fast else tol


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 128), (16, 8, 128), (16, 2, 64)])
def test_batched_decode_matches_plain_on_card(dev, dtype, fast, h, kv, d):
    """Row limits 0 (no row: acc 0, m finfo.min, l 0), 1, a tile edge and
    the whole bucket; buckets 384 (the plain version's 128-row tiles) and
    the full cache; one launch per call; a slot's bits do not depend on
    the bucket or on the other slots."""
    from qwen3_tpu_torch.ops.cuda import batched_decode as bd

    b, s, layers = 4, 512, 2
    k, v, ks, vs = (t if t is None else t.reshape(layers, b, *t.shape[1:])
                    for t in _flash_cache(h + d, layers * b, s, kv, d,
                                          dtype, dev))
    q = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    outs = {}
    for bucket, lims in ((384, [0, 1, 256, 384]), (None, [0, 1, 256, 512])):
        lim = torch.tensor(lims, dtype=torch.int32, device=dev)
        want = bd.batched_decode_plain(q, k, v, 1, lim, ks, vs,
                                       bucket=bucket, fast=fast)
        bd.reset_launches()
        got = bd.batched_decode_partial(q, k, v, 1, lim, ks, vs,
                                        bucket=bucket, fast=fast)
        torch.cuda.synchronize()
        assert bd.LAUNCHES == {"batched_decode_partial": 1}
        assert all(torch.isfinite(t).all() for t in got)
        assert torch.equal(got[0][0], torch.zeros_like(got[0][0]))
        assert (got[1][0] == torch.finfo(torch.float32).min).all()
        assert torch.equal(got[2][0], torch.zeros_like(got[2][0]))
        assert (got[1] - want[1]).abs().max().item() <= 2e-5 * max(
            1.0, want[1][1:].abs().max().item())     # slots with rows
        assert (got[2] - want[2]).abs().max().item() <= 2e-5 * max(
            1.0, want[2].abs().max().item())
        mag = bd.batched_decode_magnitude(q, k, v, 1, lim, ks, vs,
                                          bucket=bucket)
        assert ((got[0] - want[0]).abs()
                <= _value_tol(want[0], mag, fast)).all()
        outs[bucket] = got
    # slots 1 and 2 have the same rows under both buckets
    for t384, tall in zip(outs[384], outs[None]):
        assert torch.equal(t384[1:3], tall[1:3])
    q2 = q.clone()
    q2[0] += 1.0
    lim = torch.tensor([0, 1, 256, 512], dtype=torch.int32, device=dev)
    other = bd.batched_decode_partial(q2, k, v, 1, lim, ks, vs, bucket=None,
                                      fast=fast)
    for a, c in zip(other, outs[None]):
        assert torch.equal(a[1:], c[1:])
    # q = 0: every live p is exactly 1 in any frame, so under `fast` both
    # round the same p * vs and acc agrees to the fp32 sums' order; without
    # that rounding it would not
    zero = torch.zeros_like(q)
    want0 = bd.batched_decode_plain(zero, k, v, 1, lim, ks, vs, bucket=None,
                                    fast=fast)
    got0 = bd.batched_decode_partial(zero, k, v, 1, lim, ks, vs,
                                     bucket=None, fast=fast)
    tol0 = _value_tol(want0[0], None, False)
    assert (got0[0] - want0[0]).abs().max().item() <= tol0
    if fast and vs is not None:
        raw = bd.batched_decode_plain(zero, k, v, 1, lim, ks, vs,
                                      bucket=None, fast=False)
        assert (raw[0] - want0[0]).abs().max().item() > tol0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flash_two_segment_matches_plain_on_card(dev, dtype):
    """Base positions 0 (no main tile), 1, 255, 256 and S-1, side offsets
    across the 32-row chunk, with and without `live`."""
    from qwen3_tpu_torch.ops.cuda import flash_decode as fd

    b, s, c, h, kv, d = 5, 512, 32, 16, 8, 128
    k, v, ks, vs = _flash_cache(3, b, s, kv, d, dtype, dev)
    sk, sv, sks, svs = _flash_cache(4, b, c, kv, d, dtype, dev)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, h, d)).astype(np.float32)).to(dev)
    base = torch.tensor([0, 1, 255, 256, 511], dtype=torch.int32,
                        device=dev)
    off = torch.tensor([0, 31, 7, 16, 3], dtype=torch.int32, device=dev)
    want = fd.flash_decode_two_segment_plain(q, k, v, sk, sv, base, off, ks,
                                             vs, sks, svs)
    for live in (None, 511):
        fd.reset_launches()
        got = fd.flash_decode_gqa_two_segment(q, k, v, sk, sv, base, off, ks,
                                              vs, sks, svs, live=live)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["flash_decode_two_segment"] == 1
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_rows_matches_plain_on_card(dev, dtype):
    """One launch writes every slot's row at its own position, duplicate
    and edge positions included, bit-equal to the indexed assignment (bf16
    rounds to nearest even in both); every other row unchanged."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    L, B, S, KV, D = 3, 8, 16, 2, 64
    rng = np.random.default_rng(0)
    cache = torch.from_numpy(rng.standard_normal((L, B, S, KV, D)).astype(
        np.float32)).to(dev).to(dtype)
    rows = torch.from_numpy(rng.standard_normal((B, KV, D)).astype(
        np.float32)).to(dev)
    positions = torch.tensor([0, 3, 3, S - 1, 7, 0, S - 1, 5], device=dev)
    for layer in (0, L - 1):
        kw.reset_launches()
        got = kw.kv_write_rows(cache.clone(), rows, layer, positions)
        want = kw.kv_write_rows_plain(cache.clone(), rows, layer, positions)
        torch.cuda.synchronize()
        assert kw.LAUNCHES["kv_write"] == 1
        assert torch.equal(got, want)
        keep = torch.ones(L, B, S, dtype=torch.bool, device=dev)
        keep[layer, torch.arange(B, device=dev), positions] = False
        assert torch.equal(got[keep], cache[keep])


def test_kv_write_rows_refuses_on_card(dev):
    """Other cache dtypes raise, and so do rows on another device than the
    cache (a CUDA tensor meeting a CPU one, either way round)."""
    from qwen3_tpu_torch.ops.cuda import kv_write as kw

    rows = torch.zeros(2, 1, 8, device=dev)
    with pytest.raises(TypeError):
        kw.kv_write_rows(torch.zeros(1, 2, 4, 1, 8, dtype=torch.int8,
                                     device=dev), rows, 0, [0, 1])
    with pytest.raises(ValueError):
        kw.kv_write_rows(torch.zeros(1, 2, 4, 1, 8, device=dev), rows.cpu(),
                         0, [0, 1])
    with pytest.raises(ValueError):
        kw.kv_write_rows(torch.zeros(1, 2, 4, 1, 8), rows, 0, [0, 1])


# (n, G): one and two 512-wide k-tiles, w2's six, the whole-axis fallback at
# n = 768, and the tiny preset's G = 32
UNTILED = [(512, 64), (1024, 64), (3072, 64), (768, 64), (128, 32)]


def _untiled_inputs(seed, lead, n, d, g, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(lead + (n,)).astype(
        np.float32)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(
        np.int8)).to(dev)
    ws = torch.from_numpy((0.02 / 127 * (0.5 + rng.random(
        (n // g, d)))).astype(np.float32)).to(dev)
    return x, wq, ws


@pytest.mark.parametrize("lead", [(1,), (8,), (9,), (2, 33)])
@pytest.mark.parametrize("n,g", UNTILED)
def test_q8q8_untiled_matches_plain_on_card(dev, lead, n, g):
    """q8_q8_matmul_pallas on [n, d] weights, bit for bit: the k-tiles
    split across blocks (small b) and walked by one block (b = 66), the
    8-row and the 64-row blocks."""
    from qwen3_tpu_torch.ops.q8 import quantize_act

    x, wq, ws = _untiled_inputs(n + len(lead), lead, n, 200, g, dev)
    xq, xs = quantize_act(x, g)
    tq.reset_launches()
    got = tq.q8_q8_matmul_pallas(xq, xs, wq, ws, g)
    want = tq.q8_q8_matmul_pallas_plain(xq, xs, wq, ws, g)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["q8q8_pallas"] == 1
    assert got.shape == lead + (200,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("postscale", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(1,), (8,), (2, 33)])
@pytest.mark.parametrize("n,g", UNTILED)
def test_q8_untiled_matches_plain_on_card(dev, lead, n, g, cdt, postscale):
    """q8_matmul_pallas on [n, d] weights within 1e-5 * max|plain|: the
    kernel sums each dot as an fmaf chain in k order, torch.matmul in its
    own order (products of bf16 values are exact in fp32, so bf16 differs
    by the same sums' order only)."""
    x, wq, ws = _untiled_inputs(n * 3 + len(lead), lead, n, 196, g, dev)
    for xin in (x, x.to(torch.bfloat16)):
        tq.reset_launches()
        got = tq.q8_matmul_pallas(xin, wq, ws, g, compute_dtype=cdt,
                                  postscale=postscale)
        want = tq.q8_matmul_pallas_plain(xin, wq, ws, g, compute_dtype=cdt,
                                         postscale=postscale)
        torch.cuda.synchronize()
        assert tq.LAUNCHES["pallas"] == 1
        assert got.shape == lead + (196,)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_untiled_refuse_on_card(dev):
    """d % 4 != 0, a CPU weight beside CUDA activations, and a compute
    dtype other than f32 and bf16 raise."""
    from qwen3_tpu_torch.ops.q8 import quantize_act

    x, wq, ws = _untiled_inputs(0, (2,), 128, 64, 32, dev)
    xq, xs = quantize_act(x, 32)
    with pytest.raises(ValueError):
        tq.q8_q8_matmul_pallas(xq, xs, wq[:, :62].contiguous(),
                               ws[:, :62].contiguous(), 32)
    with pytest.raises(ValueError):
        tq.q8_q8_matmul_pallas(xq, xs, wq.cpu(), ws.cpu(), 32)
    with pytest.raises(ValueError):
        tq.q8_matmul_pallas(x, wq, ws, 32, compute_dtype=torch.float16)


@pytest.mark.parametrize("shape", [(3, 512, 1024), (2, 384, 2560),
                                   (2, 256, 768)])
def test_pure_read_matches_plain_on_card(dev, shape):
    """Both pure-read kernels give the plain checksum at every layer and
    n_buf, each call one launch; the manual ring needs tk <= 512, so the
    n = 768 case (tk = 768, the whole axis) runs the GEMV walk only."""
    from qwen3_tpu_torch.tools import probe_dma as pd

    rng = np.random.default_rng(shape[2])
    w = torch.from_numpy(rng.integers(-128, 128, shape).astype(
        np.int8)).to(dev)
    for layer in range(shape[0]):
        want = pd.pure_read_plain(w, layer)
        pd.reset_launches()
        got = pd.pure_read_stacked(w, layer)
        torch.cuda.synchronize()
        assert pd.LAUNCHES["pure_read_stacked"] == 1
        assert torch.equal(got, want)
        if shape[2] == 768:
            with pytest.raises(ValueError):
                pd.pure_read_manual(w, layer, 2)
            continue
        for n_buf in pd.N_BUFS:
            got = pd.pure_read_manual(w, layer, n_buf)
            torch.cuda.synchronize()
            assert torch.equal(got, want), n_buf
        assert pd.LAUNCHES["pure_read_manual"] == len(pd.N_BUFS)
