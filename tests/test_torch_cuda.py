"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels are bit-equal to their plain versions: the group dots are exact
integers and the fp32 scale-and-sum rounds every product and every sum in the
same order in both (see qwen3_tpu_torch/csrc/q8_matmul.cu).
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


def test_forward_on_card_matches_cpu(dev, tmp_path):
    """A `tiny` model's prefill and decode logits on the card against the
    same model on the CPU (plain versions): the kernels are bit-equal to
    their plain versions; the other ops (rsqrt, exp, the attention
    einsums) may differ by ulps between the devices, hence 1e-4."""
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
                                  k, v, 0, all_logits=True)
        dec, k, v = model.decode_forward(
            p, cfg, torch.tensor([7], device=device), k, v,
            torch.tensor([16], device=device))
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
