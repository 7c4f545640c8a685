"""The norm folds (qwen3_tpu_torch/ops/norms.py: add_rmsnorm, add_rms_inv,
qk_norm_rope) and the sampler kernels' one-pass designs on the CPU.

- On a CPU tensor each fold is its chain, bit for bit (x + y, then
  rmsnorm_plain or rms_inv_plain; rmsnorm_plain, then apply_rope), launches
  nothing, and holds 1e-6 of the JAX package's norms and rope on the same
  numpy inputs; qk_norm_rope in both cos/sin layouts the model builds
  (the prefill's [T, 1, half], a decode step's [B, 1, 1, half]) and on q/k
  views of a qkv output.
- A forward pass calls the norm entries 3 L + 1 times (2 plain norms, 2 L -
  1 adds, L QK-norm ropes), fused or not, and the Engine with the folds
  gives the JAX engine's seeded stream on preset tiny8 in modes pallas and
  pallas-fast, with the fused matmuls on and off (the forward pass in every
  mode is held to the JAX package's in test_torch_quant_modes.py, and the
  streams on tiny in test_torch_engine.py).
- The sampler kernels' split over the SMs, spelled in plain ops: softmax_sum
  as 32 one-warp blocks whose sums the last adds by the warp tree, and
  prefix_sum's single pass whose tiles publish their totals in any order
  and add the earlier ones in order; each equal to softmax_sum_ordered /
  cumsum_ordered, the kernels' bits.
The kernels themselves are held to these chains on the card
(tests/test_torch_cuda.py -k "fold or sampler_order")."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.config import PRESETS  # noqa: E402
from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.ops import norms as jnorms  # noqa: E402
from qwen3_tpu.ops import rope as jrope  # noqa: E402
from qwen3_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from qwen3_tpu.runtime.engine import EngineConfig as JaxConfig  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tq  # noqa: E402
from qwen3_tpu_torch.ops import norms as tnorms  # noqa: E402
from qwen3_tpu_torch.ops.cuda import norms as cn  # noqa: E402
from qwen3_tpu_torch.ops.cuda import sampler as cs  # noqa: E402
from qwen3_tpu_torch.ops.rope import apply_rope, rope_tables  # noqa: E402
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402

# the QK-norm's head_dim and the model dims of qwen3-0.6b, 4b and 8b, and a
# ragged width that takes the kernel's scalar path
WIDTHS = (128, 1024, 2560, 4096, 130)
DTYPES = (torch.float32, torch.bfloat16)
LAYOUTS = ("prefill", "decode")
PROMPT = "in the beginning"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops, which gain nothing from
    intra-op threads and lose much to them when the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _w(seed, n):
    return (1 + 0.1 * _x(seed, (n,), 1.0)).astype(np.float32)


def _qk(seed, layout, d, B=2, T=3, H=4, KV=2):
    """q [B, T, H, d] and k [B, T, KV, d] as views of one qkv output, and
    cos/sin as the model builds them: [T, 1, half] for a block at positions
    5 .., [B, 1, 1, half] for a decode step at a position a slot (T = 1);
    as numpy arrays, then as tensors."""
    if layout == "decode":
        T = 1
    qkv = _x(seed, (B, T, (H + 2 * KV) * d))
    q = qkv[..., :H * d].reshape(B, T, H, d)
    k = qkv[..., H * d:(H + KV) * d].reshape(B, T, KV, d)
    cos, sin = (t.numpy() for t in rope_tables(d, 64, device="cpu"))
    if layout == "prefill":
        pos = np.arange(5, 5 + T)
        cos, sin = cos[pos][:, None, :], sin[pos][:, None, :]
    else:
        pos = np.array([7, 40])[:B]
        cos, sin = cos[pos][:, None, None, :], sin[pos][:, None, None, :]
    tq_ = torch.from_numpy(qkv)[..., :H * d].reshape(B, T, H, d)
    tk_ = torch.from_numpy(qkv)[..., H * d:(H + KV) * d].reshape(B, T, KV, d)
    return (q, k, cos, sin), (tq_, tk_, torch.from_numpy(cos),
                              torch.from_numpy(sin))


# -- the folds on the CPU -----------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", WIDTHS)
def test_add_folds_on_cpu_are_the_chain(n, dtype):
    """add_rmsnorm and add_rms_inv on a CPU tensor: x + y, then the
    torch.mean chain on the sum, bit for bit; nothing launched."""
    x = torch.from_numpy(_x(n, (3, 5, n))).to(dtype)
    y = torch.from_numpy(_x(n + 1, (3, 5, n), 0.5)).to(dtype)
    w = torch.from_numpy(_w(n + 2, n))
    cn.reset_launches()
    s, h = tnorms.add_rmsnorm(x, y, w)
    s2, inv = tnorms.add_rms_inv(x, y)
    assert s.dtype == h.dtype == dtype and inv.dtype == torch.float32
    assert torch.equal(s, x + y) and torch.equal(s2, x + y)
    assert torch.equal(h, tnorms.rmsnorm_plain(x + y, w))
    assert torch.equal(inv, tnorms.rms_inv_plain(x + y))
    ps, ph = tnorms.add_rmsnorm_plain(x, y, w)
    assert torch.equal(ps, s) and torch.equal(ph, h)
    assert not any(cn.LAUNCHES.values()), cn.LAUNCHES


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_qk_norm_rope_on_cpu_is_the_chain(d, dtype, layout):
    """qk_norm_rope on CPU q/k views: apply_rope(rmsnorm_plain(.), cos,
    sin) for q and for k, bit for bit, in f32 (a bf16 head times the f32
    tables promotes), equal on the views' contiguous copies; nothing
    launched."""
    _, (q, k, cos, sin) = _qk(d, layout, d)
    q, k = q.to(dtype), k.to(dtype)
    wq = torch.from_numpy(_w(d + 1, d))
    wk = torch.from_numpy(_w(d + 2, d))
    cn.reset_launches()
    gq, gk = tnorms.qk_norm_rope(q, k, wq, wk, cos, sin)
    assert gq.dtype == gk.dtype == torch.float32
    assert gq.shape == q.shape and gk.shape == k.shape
    assert torch.equal(gq, apply_rope(tnorms.rmsnorm_plain(q, wq), cos, sin))
    assert torch.equal(gk, apply_rope(tnorms.rmsnorm_plain(k, wk), cos, sin))
    cq, ck = tnorms.qk_norm_rope(q.contiguous(), k.contiguous(), wq, wk, cos,
                                 sin)
    assert torch.equal(cq, gq) and torch.equal(ck, gk)
    assert not any(cn.LAUNCHES.values()), cn.LAUNCHES


@pytest.mark.parametrize("n", WIDTHS)
def test_add_folds_match_jax(n):
    """The CPU folds against qwen3_tpu/ops/norms.py on x + y, the same numpy
    inputs: within 1e-6 (XLA:CPU's rsqrt and reduction order may differ by
    an ulp); the sum itself exactly."""
    x, y = _x(2 * n, (4, 7, n)), _x(2 * n + 1, (4, 7, n), 0.5)
    w = _w(2 * n + 2, n)
    s, h = tnorms.add_rmsnorm(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w))
    _, inv = tnorms.add_rms_inv(torch.from_numpy(x), torch.from_numpy(y))
    js = jnp.asarray(x) + jnp.asarray(y)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(
        h.numpy(), np.asarray(jnorms.rmsnorm(js, jnp.asarray(w))),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jnorms.rms_inv(js)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("d", WIDTHS)
def test_qk_norm_rope_matches_jax(d, layout):
    """qk_norm_rope on the CPU against the JAX package's rmsnorm, then its
    apply_rope (qwen3_tpu/ops/rope.py), on the same numpy inputs: within
    1e-6 of the output's magnitude (an ulp of the norm moves a difference
    of two products by an ulp of the products, not of the difference)."""
    (q, k, cos, sin), (tq_, tk_, tcos, tsin) = _qk(3 * d, layout, d)
    wq, wk = _w(d + 3, d), _w(d + 4, d)
    gq, gk = tnorms.qk_norm_rope(tq_, tk_, torch.from_numpy(wq),
                                 torch.from_numpy(wk), tcos, tsin)
    for got, x, w in ((gq, q, wq), (gk, k, wk)):
        want = np.asarray(jrope.apply_rope(
            jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w)), jnp.asarray(cos),
            jnp.asarray(sin)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_folds_refuse_what_the_kernel_does_not_take():
    """The wrappers' checks, which run before any launch: a CPU tensor, y
    unlike x, a strided x, an odd or too wide head, q and k of different
    tokens, tables that do not broadcast or are not f32."""
    x, w = torch.zeros(2, 16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cn.add_rmsnorm_cuda(x, x, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cn.add_rms_inv_cuda(x, x)
    with pytest.raises(ValueError, match="must match x"):
        cn.check_add(x, x.to(torch.bfloat16), None)
    with pytest.raises(ValueError, match="must match x"):
        cn.check_add(x, torch.zeros(2, 15), None)
    with pytest.raises(ValueError, match="contiguous"):
        cn.check_add(torch.zeros(16, 2).T, torch.zeros(2, 16), w)
    cn.check_add(x, x, w)
    B, T, D = 2, 3, 8
    q, k = torch.zeros(B, T, 4, D), torch.zeros(B, T, 2, D)
    wd = torch.ones(D)
    cos = torch.zeros(T, 1, D // 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cn.qk_norm_rope_cuda(q, k, wd, wd, cos, cos)
    assert cn.check_qk(q, k, wd, wd, cos, cos)[2:] == (0, D // 2)
    dec = torch.zeros(B, 1, 1, D // 2)
    assert cn.check_qk(q[:, :1], k[:, :1], wd, wd, dec, dec)[2:] == (
        D // 2, D // 2)
    with pytest.raises(ValueError, match="even head_dim"):
        cn.check_qk(q[..., :7], k[..., :7], wd[:7], wd[:7], cos, cos)
    wide = cn.QK_MAX_HEAD + 2
    with pytest.raises(ValueError, match="even head_dim"):
        cn.check_qk(torch.zeros(1, 1, 1, wide), torch.zeros(1, 1, 1, wide),
                    torch.ones(wide), torch.ones(wide),
                    torch.zeros(1, 1, wide // 2), torch.zeros(1, 1, wide // 2))
    with pytest.raises(ValueError, match="one B, T and"):
        cn.check_qk(q, k[:, :2], wd, wd, cos, cos)
    with pytest.raises(ValueError, match="does not broadcast"):
        cn.check_qk(q, k, wd, wd, torch.zeros(T + 1, 1, D // 2),
                    torch.zeros(T + 1, 1, D // 2))
    with pytest.raises(TypeError, match="float32"):
        cn.check_qk(q, k, wd, wd, cos.double(), cos.double())
    with pytest.raises(ValueError, match="must match q"):
        cn.check_qk(q, k.to(torch.bfloat16), wd, wd, cos, cos)


# -- the folds in the model -------------------------------------------------

@pytest.mark.parametrize("mode,fuse", [("pallas", False), ("pallas", True),
                                       ("pallas-fast", True), ("exact", False),
                                       ("bf16", False)])
def test_forward_pass_calls_the_norm_entries(monkeypatch, mode, fuse):
    """Each forward pass, a prefill block or a decode step: 2 plain norms
    (layer 0's attention norm, the output norm), 2 L - 1 adds with their
    norm, L QK-norm ropes; rms_inv and add_rms_inv where the matmuls are
    fused, rmsnorm and add_rmsnorm elsewhere."""
    cfg = PRESETS["tiny8"]
    L = cfg.n_layers
    calls = {}

    def counting(name):
        fn = getattr(tq, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return counted

    for name in ("rmsnorm", "rms_inv", "add_rmsnorm", "add_rms_inv",
                 "qk_norm_rope"):
        monkeypatch.setattr(tq, name, counting(name))
    p = tq.init_params(synthetic_weights(cfg, seed=0), mode=mode,
                       max_seq_len=64, device="cpu")
    k, v = tq.init_kv_cache(cfg, 2, 64, "int8", "cpu")
    tq.forward(p, cfg, torch.tensor([[5, 9, 200], [1, 2, 3]]), k, v, 0,
               mode=mode, fuse=fuse)
    tq.decode_forward(p, cfg, torch.tensor([7, 8]), k, v,
                      torch.tensor([3, 3]), mode=mode, fuse=fuse)
    plain, add = ("rms_inv", "add_rms_inv") if fuse else ("rmsnorm",
                                                          "add_rmsnorm")
    assert calls == {plain: 2 * 2, add: 2 * (2 * L - 1),
                     "qk_norm_rope": 2 * L}


# the seeded streams that no other test holds: tiny8 (test_torch_engine.py
# holds tiny's unfused ones) in the pallas modes, fused and not. PROMPT has
# no Q8 or bf16 rounding flip between the packages in these four; in mode
# pallas-int8 it has one in tiny8's prefill (the unfolded model's too), so
# that its first sampled token differs at every seed while the argmax holds
# (a flip between the two packages' ulps is not a fault of either, ROADMAP.md
# Queue C #1; test_torch_quant_modes.py holds that mode's forward pass)
STREAM_CASES = [(mode, fuse) for mode in ("pallas", "pallas-fast")
                for fuse in (False, True)]


@pytest.fixture(scope="module")
def tiny8_ckpt(tmp_path_factory):
    cfg = PRESETS["tiny8"]
    path = str(tmp_path_factory.mktemp("norm_folds") / "tiny8.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=1234))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


@pytest.mark.parametrize("mode,fuse", STREAM_CASES)
def test_folded_model_tokens_match_jax(tiny8_ckpt, monkeypatch, mode,
                                       fuse):
    """The Engine (the model with the folds, on the CPU) against the JAX
    engine (QWEN3_TPU_FUSE=1 where fuse): a seeded stream of 16 tokens,
    int8 KV."""
    if fuse:
        jax.clear_caches()
        monkeypatch.setenv("QWEN3_TPU_FUSE", "1")
    try:
        kw = dict(path=tiny8_ckpt, seed=3, temperature=0.8, top_p=0.9,
                  mode=mode, kv_dtype="int8", seq_len=64)
        want = JaxEngine(JaxConfig(**kw)).generate(PROMPT, max_tokens=16)
        got = Engine(EngineConfig(device="cpu", fuse=fuse, **kw)).generate(
            PROMPT, max_tokens=16)
        assert got.ids == want.ids
    finally:
        if fuse:
            monkeypatch.delenv("QWEN3_TPU_FUSE")
            jax.clear_caches()


# -- the sampler kernels' split, in plain ops ---------------------------------

def _xor_tree(acc):
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc


def softmax_sum_split(e):
    """softmax_sum as the kernel runs it: each of a row's 32 one-warp
    blocks alone (block w's lanes are threads 32 w .. 32 w + 31, chunk c
    to thread c % 1024, a chain a lane, the warp's xor tree), its sum
    written; the last block's tree over the 32 sums."""
    b, n = e.shape
    per = -(-(-(-n // 4)) // cs.SUM_THREADS)
    x = torch.nn.functional.pad(e, (0, 4 * per * cs.SUM_THREADS - n))
    x = x.reshape(b, per, cs.SUM_BLOCKS, 32, 4)
    partial = torch.empty(b, cs.SUM_BLOCKS)
    for w in range(cs.SUM_BLOCKS):
        acc = torch.zeros(b, 32)
        for j in range(per):
            for i in range(4):
                acc = acc + x[:, j, w, :, i]
        partial[:, w] = _xor_tree(acc)[:, 0]
    return _xor_tree(partial)[:, 0]


def _tile_scan(v):
    """One tile [b, SCAN_TILE] as a block scans it alone: (the thread's
    inclusive sums p, the lane offsets, the warp offsets, the total)."""
    b = v.shape[0]
    warps = cs.SCAN_THREADS // 32
    v = v.reshape(b, warps, 32, cs.SCAN_PER)
    sums = [v[..., 0]]
    for i in range(1, cs.SCAN_PER):
        sums.append(sums[-1] + v[..., i])
    p = torch.stack(sums, dim=-1)
    s = p[..., -1]
    lane = torch.arange(32)
    off = 1
    while off < 32:
        up = torch.nn.functional.pad(s[..., :-off], (off, 0))
        s = torch.where(lane >= off, s + up, s)
        off *= 2
    lex = torch.nn.functional.pad(s[..., :-1], (1, 0))
    wt = s[..., -1]
    wex = [torch.zeros(b)]
    for w in range(warps):
        wex.append(wex[-1] + wt[..., w])
    total = wex.pop()
    return p, lex, torch.stack(wex, dim=-1), total


def cumsum_single_pass(x, publish_order):
    """prefix_sum's one pass: every tile scans itself and publishes its
    total, in `publish_order` (the order blocks happen to finish); a tile's
    carry is then the published totals of the earlier tiles, added in order
    from tile 0; out = ((carry + warp offset) + lane offset) + p."""
    b, n = x.shape
    nt = -(-n // cs.SCAN_TILE)
    v = torch.nn.functional.pad(x, (0, nt * cs.SCAN_TILE - n))
    v = v.reshape(b, nt, cs.SCAN_TILE)
    scans, words = {}, {}
    for j in publish_order:
        scans[j] = _tile_scan(v[:, j])
        words[j] = scans[j][3]
    out = []
    for j in range(nt):
        carry = torch.zeros(b)
        for i in range(j):
            carry = carry + words[i]
        p, lex, wex, _ = scans[j]
        off = (carry[:, None, None] + wex[..., None]) + lex
        out.append((off[..., None] + p).reshape(b, cs.SCAN_TILE))
    return torch.cat(out, dim=-1)[:, :n]


@pytest.mark.parametrize("n", [512, 151936])
def test_sampler_split_spellings_are_the_ordered_sums(n):
    """The 32-block softmax_sum and the single-pass prefix sum (tiles
    published in reverse and in a shuffled order) equal
    softmax_sum_ordered / cumsum_ordered bit for bit, at B 1 and 4."""
    rng = np.random.default_rng(n)
    p = rng.random((4, n)).astype(np.float32) ** 4
    x = torch.from_numpy(p / p.sum(axis=-1, keepdims=True))
    nt = -(-n // cs.SCAN_TILE)
    for b in (1, 4):
        xb = x[:b].contiguous()
        assert torch.equal(softmax_sum_split(xb), cs.softmax_sum_ordered(xb))
        want = cs.cumsum_ordered(xb)
        for order in (range(nt)[::-1], rng.permutation(nt)):
            assert torch.equal(cumsum_single_pass(xb, list(order)), want)
