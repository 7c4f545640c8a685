"""The port's sparse expert model (preset tiny-moe: 8 experts, top 2, a
query group of 8) on the CPU (the kernels' plain versions) against the
plain float32 reference tests/plain_qwen3_moe.py, on seeded random
weights; its checkpoint format, its HF export and its spans and counters.

No JAX here: the weights come from the port's own IO.

Tolerances are in units of the reference logits' standard deviation. A
routing decision is discontinuous: where two experts' probabilities lie
within the rounding of the activations that reach the router, the port
and the reference pick different experts, and that row's logits (and,
through its keys and values, later rows') move by a whole expert's share.
Such flips are rare and land anywhere, so the whole-model comparisons
hold the median position's largest error, and the faults that only a
tighter tolerance sees are held at the single layer, where the routing is
compared directly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plain_qwen3_moe as ref  # noqa: E402
from qwen3_tpu_torch.config import PRESETS, has_experts  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import (  # noqa: E402
    QWEN_MOE_VERSION,
    load_checkpoint,
    read_header,
    write_checkpoint,
)
from qwen3_tpu_torch.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as model  # noqa: E402
from qwen3_tpu_torch.ops.cuda import moe  # noqa: E402

CFG = PRESETS["tiny-moe"]
IDS = [(7 * i + 40) % 500 for i in range(48)]
# the median position's largest |port - reference| over the logits' std:
# pallas-fast and bf16 round activations (and weights) to bf16, about 0.02
# here; exact quantizes them to int8 a group, about 0.04; the int8 KV cache
# adds its rounding. A wrong rope, norm, mask or expert layer moves the
# median by the logits' whole spread (top 7: about 1, no renorm: 0.7).
TOL = {"pallas-fast": 0.06, "bf16": 0.06, "exact": 0.1}
TOL_INT8 = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return synthetic_weights(CFG, seed=3, scale=0.1)


@pytest.fixture(scope="module")
def want(weights):
    return ref.logits(weights, CFG, IDS)


def median_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs().amax(-1) / want.std()).median())


def test_presets():
    big = PRESETS["qwen3-30b-a3b"]
    big.validate()
    CFG.validate()
    assert (big.dim, big.n_layers, big.n_heads, big.n_kv_heads,
            big.head_dim, big.vocab_size) == (2048, 48, 32, 4, 128, 151936)
    assert (big.n_experts, big.n_experts_per_tok, big.expert_dim,
            big.hidden_dim) == (128, 8, 768, 0)
    assert CFG.kv_mul == 8 and big.kv_mul == 8
    assert has_experts(big) and not has_experts(PRESETS["qwen3-4b"])
    for bad in (dict(expert_dim=48), dict(n_experts_per_tok=9),
                dict(hidden_dim=64)):
        with pytest.raises(AssertionError):
            dataclasses.replace(CFG, **bad).validate()


@pytest.mark.parametrize("mode", ["pallas-fast", "exact", "bf16"])
def test_forward_matches_reference(weights, want, mode):
    """(a) A 48-token block's logits, every row."""
    p = model.init_params(weights, mode=mode, device="cpu")
    k, v = model.init_kv_cache(CFG, 1, 128, "float32", "cpu")
    got = model.forward(p, CFG, torch.tensor([IDS]), k, v, 0, mode=mode,
                        all_logits=True)[0][0]
    assert median_error(got, want) < TOL[mode]
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.9


@pytest.mark.parametrize("mode", ["pallas-fast", "exact", "bf16"])
def test_prefill_then_decode_matches_reference(weights, want, mode):
    """(b) 32 tokens prefilled, 16 decoded one at a time through the int8
    KV cache, against the reference's full forward over the same 48. The
    prefilled and the decoded rows are held each on their own, so that a
    fault on the decode side alone (a wrong position, a cache read) fails:
    the median row's error, and the argmax of 15 of the 16 decoded rows."""
    p = model.init_params(weights, mode=mode, device="cpu")
    k, v = model.init_kv_cache(CFG, 1, 128, "int8", "cpu")
    pre = model.forward(p, CFG, torch.tensor([IDS[:32]]), k, v, 0, mode=mode,
                        all_logits=True)[0][0]
    dec = torch.cat([
        model.decode_forward(p, CFG, torch.tensor([IDS[t]]), k, v,
                             torch.tensor([t]), mode=mode)[0]
        for t in range(32, 48)])
    assert median_error(pre, want[:32]) < TOL_INT8
    assert median_error(dec, want[32:]) < TOL_INT8
    assert int((dec.argmax(-1) == want[32:].argmax(-1)).sum()) >= 15


def test_pallas_fast_layer_bits_do_not_depend_on_the_batch(weights):
    """A row's expert-layer output is the same bits alone as among 63
    others (the kernels' design rule, held here by their plain versions)."""
    p = model.init_params(weights, mode="pallas-fast", device="cpu")
    h = torch.randn(64, CFG.dim, generator=torch.Generator().manual_seed(1))
    args = (p["wr_q"][0], p["wr_s"][0], p["we13_q"][0], p["we13_s"][0],
            p["we2_q"][0], p["we2_s"][0], CFG.n_experts_per_tok,
            CFG.group_size)
    full = moe.expert_layer(h, *args)
    for r in (0, 17, 63):
        assert torch.equal(moe.expert_layer(h[r:r + 1], *args), full[r:r + 1])


def _layer_inputs(weights, l=1):
    G = CFG.group_size
    f32 = {n: ref.dequant(getattr(weights, n + "_q")[l],
                          getattr(weights, n + "_s")[l], G)
           for n in ("wr", "we1", "we2", "we3")}
    h = torch.randn(64, CFG.dim, generator=torch.Generator().manual_seed(2))
    return h, f32


def _ref_route(h, wr, k, fault=None):
    """The reference's routing weights [N, E] (0 off the top k)."""
    w, ids = ref.route(h, wr, k, fault)
    return torch.zeros(h.shape[0], wr.shape[0]).scatter(-1, ids, w)


# the routing weights: the port's float32 router against the reference's
# differs only in the order of its sums, ~1e-7; a bf16 router moves them by
# ~1e-3. The layer's output: pallas-fast's bf16 activations and weights
# put it ~0.4% (relative norm) off the float32 layer; float8 activations
# ~4%.
ROUTE_TOL = 1e-5
LAYER_TOL = 0.015


@pytest.mark.parametrize("fault", [None, *ref.FAULTS])
def test_expert_layer_against_reference_and_faults(weights, fault):
    """(d) One expert layer, the port's (pallas-fast's plain chain) against
    the reference's, and each planted fault of the reference failing at
    least one tolerance: top 7, no renormalisation, a bf16 router, fp8
    expert activations."""
    h, f32 = _layer_inputs(weights)
    k, E = CFG.n_experts_per_tok, CFG.n_experts
    p = model.init_params(weights, mode="pallas-fast", device="cpu")
    ids, w, _ = moe.route(h, p["wr_q"][1], p["wr_s"][1], k, CFG.group_size)
    dense = torch.zeros(h.shape[0], E).scatter(-1, ids.long(), w)
    route_err = float((dense - _ref_route(h, f32["wr"], k, fault)).abs().max())
    got = moe.expert_layer(h, p["wr_q"][1], p["wr_s"][1], p["we13_q"][1],
                           p["we13_s"][1], p["we2_q"][1], p["we2_s"][1], k,
                           CFG.group_size)
    r = ref.expert_layer(h, f32["wr"], f32["we1"], f32["we2"], f32["we3"], k,
                         fault)
    layer_err = float((got - r).norm() / r.norm())
    sound = route_err < ROUTE_TOL and layer_err < LAYER_TOL
    assert sound == (fault is None), (route_err, layer_err)


@pytest.mark.parametrize("fault", ["top7", "no_renorm"])
def test_model_faults_fail_the_model_tolerance(weights, want, fault):
    """The faults that change the model's function fail the whole-model
    tolerance too."""
    bad = ref.logits(weights, CFG, IDS, fault=fault)
    assert median_error(bad, want) > TOL["exact"]


def test_attention_at_a_query_group_of_eight(weights):
    """(e) tiny-moe's 8 query heads over one kv head: the port's dense and
    flash attention (their plain versions here) against the reference's
    causal GQA, on the same q, k and v."""
    from qwen3_tpu_torch.ops.attention import gqa_attention
    from qwen3_tpu_torch.ops.cuda.flash_decode import (
        flash_decode_gqa,
        flash_prefill_gqa,
    )

    g = torch.Generator().manual_seed(4)
    T, H, KV, D = 40, CFG.n_heads, CFG.n_kv_heads, CFG.head_dim
    q = torch.randn(T, H, D, generator=g)
    k = torch.randn(T, KV, D, generator=g)
    v = torch.randn(T, KV, D, generator=g)
    want = ref.attention(q, k, v, H, KV)
    kc = torch.zeros(1, 64, KV, D)
    vc = torch.zeros(1, 64, KV, D)
    kc[0, :T], vc[0, :T] = k, v
    pos = torch.arange(T)
    dense = gqa_attention(q[None], kc, vc, pos, live=T)[0]
    flash = flash_prefill_gqa(q[None], kc, vc, pos.to(torch.int32),
                              live=T)[0]
    step = flash_decode_gqa(q[T - 1:T], kc, vc,
                            torch.tensor([T - 1], dtype=torch.int32),
                            live=T)
    # f32 attention in another order of sums: 2e-5, the port's attention
    # tolerance
    for got in (dense, flash):
        assert (got - want).abs().max() < 2e-5
    assert (step[0] - want[T - 1]).abs().max() < 2e-5


def test_forward_counts_and_raises(weights):
    p = model.init_params(weights, mode="pallas-fast", device="cpu")
    k, v = model.init_kv_cache(CFG, 2, 64, "int8", "cpu")
    before = dict(model.CALLS)
    counts = model.expert_counts(p).clone()
    model.forward(p, CFG, torch.tensor([IDS[:5], IDS[5:10]]), k, v, 0,
                  mode="pallas-fast")
    assert model.CALLS["moe_layers"] - before["moe_layers"] == CFG.n_layers
    rows = model.CALLS["moe_rows"] - before["moe_rows"]
    assert rows == 2 * 5 * CFG.n_experts_per_tok * CFG.n_layers
    assert int((model.expert_counts(p) - counts).sum()) == rows
    for mode in ("pallas", "pallas-int8"):
        with pytest.raises(NotImplementedError):
            model.init_params(weights, mode=mode, device="cpu")
        with pytest.raises(NotImplementedError):
            model.forward(p, CFG, torch.tensor([IDS[:3]]), k, v, 0,
                          mode=mode)


def test_fuse_leaves_the_expert_layer_as_it_is(weights):
    p = model.init_params(weights, mode="pallas-fast", device="cpu")
    out = []
    for fuse in (False, True):
        k, v = model.init_kv_cache(CFG, 1, 64, "int8", "cpu")
        out.append(model.forward(p, CFG, torch.tensor([IDS[:20]]), k, v, 0,
                                 mode="pallas-fast", fuse=fuse,
                                 all_logits=True)[0])
    assert torch.equal(out[0], out[1])


# -- the checkpoint, the engine, the export -------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, weights):
    path = str(tmp_path_factory.mktemp("moe") / "tiny-moe.bin")
    write_checkpoint(path, weights)
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(CFG.vocab_size))
    return path


def test_checkpoint_round_trip(ckpt, weights):
    """Header version 2 with the three expert sizes; every tensor back as
    written; the model loads through load_params."""
    with open(ckpt, "rb") as f:
        assert int.from_bytes(f.read(8)[4:], "little") == QWEN_MOE_VERSION
    assert read_header(ckpt) == CFG
    back = load_checkpoint(ckpt)
    for f in dataclasses.fields(back):
        a, b = getattr(back, f.name), getattr(weights, f.name)
        if f.name == "config" or b is None:
            assert a == b
            continue
        assert np.array_equal(np.stack(a) if isinstance(a, list) else a, b)
    cfg, p = model.load_params(ckpt, mode="pallas-fast", device="cpu")
    q = model.init_params(weights, mode="pallas-fast", device="cpu")
    assert cfg == CFG
    for key in ("we13_q", "we13_s", "we2_q", "we2_s"):
        assert all(torch.equal(a, b) for a, b in zip(p[key], q[key]))
    with pytest.raises(NotImplementedError):
        model.load_params(ckpt, mode="pallas-fast", device="cpu", tp=2)


def test_dense_checkpoint_stays_version_one(tmp_path):
    path = str(tmp_path / "tiny.bin")
    write_checkpoint(path, synthetic_weights(PRESETS["tiny"], seed=1))
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8)[4:], "little") == 1
    assert read_header(path) == PRESETS["tiny"]


def test_batched_engine_serves_the_single_stream(ckpt):
    """(c) Three greedy requests at once on BatchedEngine (per-slot KV
    writes, and the side buffer) give each the stream of decoding it alone
    through forward (the single-stream Engine)."""
    from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig

    prompts = ["the cat", "in the hat and er", "on at the the"]
    alone = []
    for pr in prompts:
        eng = Engine(EngineConfig(path=ckpt, seed=1, temperature=0.0,
                                  top_p=0.9, seq_len=96, mode="pallas-fast",
                                  prefill_chunk=16, decode_chunk=8,
                                  kv_dtype="int8", device="cpu"))
        alone.append(eng.generate(pr, max_tokens=12).ids)
    for side in (False, True):
        beng = BatchedEngine(ckpt, max_batch=3, seq_len=96,
                             mode="pallas-fast", temperature=0.0, top_p=0.9,
                             prefill_bucket=16, decode_chunk=8,
                             kv_dtype="int8", side_buffer=side,
                             attn="dense", device="cpu")
        reqs = [beng.submit(Request(prompt=pr, seed=1, max_tokens=12))
                for pr in prompts]
        beng.run()
        assert [r.prompt_ids + r.out_ids for r in reqs] == alone


def test_hf_export_maps_qwen3_moe_names(tmp_path):
    """A synthetic qwen3_moe state dict at tiny-moe's size through the
    exporter: the router and every expert's three matrices land where the
    port reads them, within Q8_0 rounding."""
    from qwen3_tpu_torch.io.hf_export import export_state

    rng = np.random.default_rng(0)
    L, D, E, F = CFG.n_layers, CFG.dim, CFG.n_experts, CFG.expert_dim
    H, KV, HD, V = CFG.n_heads, CFG.n_kv_heads, CFG.head_dim, CFG.vocab_size

    def mat(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    state = {"model.embed_tokens.weight": mat(V, D),
             "lm_head.weight": mat(V, D), "model.norm.weight": mat(D) + 1}
    for i in range(L):
        pre = f"model.layers.{i}."
        state.update({
            pre + "input_layernorm.weight": mat(D) + 1,
            pre + "post_attention_layernorm.weight": mat(D) + 1,
            pre + "self_attn.q_norm.weight": mat(HD) + 1,
            pre + "self_attn.k_norm.weight": mat(HD) + 1,
            pre + "self_attn.q_proj.weight": mat(H * HD, D),
            pre + "self_attn.k_proj.weight": mat(KV * HD, D),
            pre + "self_attn.v_proj.weight": mat(KV * HD, D),
            pre + "self_attn.o_proj.weight": mat(D, H * HD),
            pre + "mlp.gate.weight": mat(E, D)})
        for e in range(E):
            state[pre + f"mlp.experts.{e}.gate_proj.weight"] = mat(F, D)
            state[pre + f"mlp.experts.{e}.up_proj.weight"] = mat(F, D)
            state[pre + f"mlp.experts.{e}.down_proj.weight"] = mat(D, F)
    cfg_json = {"model_type": "qwen3_moe", "hidden_size": D,
                "num_hidden_layers": L, "num_attention_heads": H,
                "num_key_value_heads": KV, "vocab_size": V,
                "intermediate_size": 6144, "max_position_embeddings": 128,
                "head_dim": HD, "num_experts": E,
                "num_experts_per_tok": CFG.n_experts_per_tok,
                "moe_intermediate_size": F, "decoder_sparse_step": 1,
                "mlp_only_layers": [], "norm_topk_prob": True}
    path = str(tmp_path / "moe.bin")
    cfg = export_state(state, cfg_json, path, group_size=CFG.group_size)
    assert cfg == dataclasses.replace(CFG, shared_classifier=False)
    w = load_checkpoint(path)
    G = CFG.group_size
    for i in (0, L - 1):
        pre = f"model.layers.{i}."
        got = ref.dequant(w.wr_q[i], w.wr_s[i], G).numpy()
        assert np.abs(got - state[pre + "mlp.gate.weight"]).max() < 2e-3
        for e in (0, E - 1):
            for ours, theirs in (("we1", "gate_proj"), ("we2", "down_proj"),
                                 ("we3", "up_proj")):
                got = ref.dequant(getattr(w, ours + "_q")[i][e],
                                  getattr(w, ours + "_s")[i][e], G).numpy()
                want = state[pre + f"mlp.experts.{e}.{theirs}.weight"]
                assert np.abs(got - want).max() < 2e-3
    assert w.w1_q is None and w.w2_q is None and w.w3_q is None
