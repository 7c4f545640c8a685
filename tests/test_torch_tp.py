"""The port's tensor- and data-parallel programs (qwen3_tpu_torch/parallel/)
against the JAX package's mesh programs (qwen3_tpu/parallel/tp.py).

The port runs one process a rank: each world below is a set of ranks
spawned over gloo on the CPU (parallel/launch.py::spawn_ranks), running the
rank bodies of tests/torch_tp_ranks.py (torch and the port only) while this
process computes the JAX side on the 8 virtual CPU devices of
tests/conftest.py, Pallas in interpret mode. Weights reach the ranks as the
JAX tp pytree (tp_host_params, a leading [tp, ...] axis), each rank taking
its shard through params_from_jax, and as a checkpoint file.

Tolerances are the JAX package's own tests' (tests/test_tp.py): logits, K
and V within 2e-5 (rtol and atol) at tp 2, logits within 3e-5 at tp 4 and
8, a continuation's owner logits within 2e-4; the fused prologue at 2e-4
(test_tp_forward_fused_prologue). Token streams are equal. Inside a shard
the integer math is the single device's; the only fp32 order that moves is
the sum over wo/w2 partials. The inputs are those of tests/test_tp.py; none
of them has a Q8 rounding flip between the packages (ROADMAP Queue C #1).
"""

import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from qwen3_tpu.config import PRESETS as JPRESETS  # noqa: E402
from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from qwen3_tpu.parallel import tp as jtp  # noqa: E402
from qwen3_tpu_torch.config import PRESETS, has_experts  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import load_checkpoint  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tq  # noqa: E402
from qwen3_tpu_torch.parallel import launch  # noqa: E402
from qwen3_tpu_torch.parallel import shard_layout as layout  # noqa: E402
from qwen3_tpu_torch.parallel import tp as ptp  # noqa: E402

SEQ, T = R.SEQ, R.T
WORLD_TIMEOUT_S = 300


def _jax_weights(preset, seed):
    return dataclasses.replace(synthetic_weights(JPRESETS[preset], seed=seed),
                               config=R.cfg_of(preset))


def _write(d, name, w):
    path = str(d / f"{name}.bin")
    write_checkpoint(path, w)
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(w.config.vocab_size))
    return path


def _placed(w, dp, tp):
    mesh = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    params = jtp.place_params(jtp.tp_host_params(w, tp), mesh,
                              w.config.head_dim, SEQ)
    return mesh, params


def _save_pytree(d, name, params):
    np.savez(d / name, **{k: np.asarray(jax.device_get(v))
                          for k, v in params.items()})


def _results(ctx, d, world):
    """Wait for the world (a rank's failure raises here with its
    traceback) and read every rank's results."""
    t0 = time.monotonic()
    while not ctx.join(timeout=1):
        if time.monotonic() - t0 > WORLD_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the ranks did not finish")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _np(x):
    return np.asarray(jax.device_get(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _heads(kv, rank_tp, tp, b=slice(None)):
    """JAX's global K or V [L, B, S, KV, D]: a rank's rows and kv heads."""
    kv = _np(kv)
    n = kv.shape[3] // tp
    return kv[:, b, :T, rank_tp * n:(rank_tp + 1) * n]


# -- pure functions and the shard ----------------------------------------


# the dense presets (the JAX package's): the expert presets do not run
# tensor-parallel (models/qwen3.py::check_moe)
@pytest.mark.parametrize("name", sorted(n for n in PRESETS
                                        if not has_experts(PRESETS[n])))
def test_check_tp_and_local_config_match_jax(name):
    cfg, jcfg = PRESETS[name], JPRESETS[name]
    for tp in (1, 2, 4, 8):
        try:
            want = dataclasses.asdict(jtp.local_config(jcfg, tp))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                layout.local_config(cfg, tp)
            continue
        layout.check_tp(cfg, tp)
        got = dataclasses.asdict(layout.local_config(cfg, tp))
        # the port's expert fields, 0 in a dense model
        assert [got.pop(k) for k in ("n_experts", "n_experts_per_tok",
                                     "expert_dim")] == [0, 0, 0]
        assert got == want


def test_local_config_shard_geometries():
    """The shard dims the chip run launches (qwen3-4b's w2 at tp 2 contracts
    over 4864, 76 groups of 64; its classifier 75968 rows)."""
    loc = layout.local_config(PRESETS["qwen3-4b"], 2)
    assert (loc.hidden_dim, loc.vocab_size, loc.n_kv_heads) == (4864, 75968, 4)
    assert layout.local_config(PRESETS["qwen3-4b"], 8).hidden_dim == 1216
    assert layout.local_config(PRESETS["qwen3-0.6b"], 2).n_kv_heads == 4
    with pytest.raises(ValueError):
        layout.local_config(PRESETS["tiny"], 4)


@pytest.mark.parametrize("preset,tp", [("tiny", 2), ("tiny8", 4),
                                       ("tiny8", 8)])
def test_rank_shard_equals_jax_shard(tmp_path, preset, tp):
    """Each rank's shard (tp_host_params on the port's checkpoint read)
    equals the JAX tp pytree's shard un-tiled, and params_from_jax carries
    the JAX shard across to the same tensors."""
    w = _jax_weights(preset, 3)
    path = _write(tmp_path, preset, w)
    jax_tp = jtp.tp_host_params(w, tp)
    loc = layout.local_config(R.cfg_of(preset), tp)
    d_out = {"wqkv": loc.proj_dim + 2 * loc.kv_dim, "wo": loc.dim,
             "w13": 2 * loc.hidden_dim, "w2": loc.dim,
             "cls": loc.vocab_size}
    pw = load_checkpoint(path)
    jp = {k: np.asarray(v) for k, v in jax_tp.items()}
    jp["rope_cos"] = jp["rope_sin"] = np.zeros((SEQ, 1), np.float32)
    for rank in range(tp):
        mine = ptp.tp_host_params(pw, tp, rank)
        carried = tq.params_from_jax(jp, R.cfg_of(preset), device="cpu",
                                     rank=rank)
        for name, d in d_out.items():
            for part in ("_q", "_s"):
                want = tq.untile(jax_tp[name + part][rank], d)
                np.testing.assert_array_equal(mine[name + part], want)
                np.testing.assert_array_equal(
                    carried[name + part].numpy(), want)


def test_load_params_refuses_tp_outside_pallas(tmp_path):
    path = _write(tmp_path, "tiny", _jax_weights("tiny", 3))
    for mode in ("bf16", "exact"):
        with pytest.raises(ValueError, match="pallas"):
            tq.load_params(path, mode, device="cpu", tp=2, rank=0)


# -- world: tiny at (dp 1, tp 2) -------------------------------------------


@pytest.fixture(scope="module")
def tiny_tp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp2")
    w = _jax_weights("tiny", 3)
    path = _write(d, "tiny", w)
    mesh, params = _placed(w, 1, 2)
    _save_pytree(d, "jax_tp2.npz", params)
    ctx = launch.spawn_ranks(R.world_tiny_tp2, 2, (str(d),), device="cpu")

    # the JAX side while the ranks run
    want = {}
    cfg = w.config
    toks = jnp.asarray(R.block_tokens(2).numpy(), jnp.int32)
    for name, mode, fuse in R.FWD_MODES:
        # the JAX package reads QWEN3_TPU_FUSE while it traces
        os.environ["QWEN3_TPU_FUSE"] = "1" if fuse else "0"
        try:
            kv = jtp.init_sharded_kv(cfg, 2, SEQ, jnp.float32, mesh)
            fwd = jtp.make_tp_forward(mesh, cfg, params, kv, mode=mode)
            want["fwd_" + name] = tuple(map(_np, fwd(
                params, toks, kv[0], kv[1], jnp.int32(0), jnp.int32(T - 1))))
        finally:
            os.environ.pop("QWEN3_TPU_FUSE")
    kv = jtp.init_sharded_kv(cfg, 2, SEQ, jnp.float32, mesh)
    _, k, v = jtp.make_tp_forward(mesh, cfg, params, kv, mode="pallas")(
        params, toks, kv[0], kv[1], jnp.int32(0), jnp.int32(T - 1))
    step = jtp.make_tp_decode_step(mesh, cfg, params, (k, v), mode="pallas")
    want["step"] = step(params, jnp.arange(2, dtype=jnp.int32) + 5, k, v,
                        jnp.asarray([T, T + 1], jnp.int32))[0]
    from qwen3_tpu.runtime.xorshift import seed_to_device
    statics = dict(mode="pallas", chunk=8, temperature=0.0, top_p=0.9,
                   greedy=True, bos=0, eos=1, emit_at_limit=False, top_k=0,
                   attn="dense")
    kv = jtp.init_sharded_kv(cfg, 1, SEQ, jnp.float32, mesh)
    hi, lo = seed_to_device(3)
    want["chunk"] = jtp.make_tp_decode_chunk(mesh, cfg, params, kv,
                                             **statics)(
        params, kv[0], kv[1], jnp.asarray([7], jnp.int32), jnp.int32(0),
        jnp.int32(SEQ), hi, lo)[0]
    from qwen3_tpu.runtime.engine import Engine, EngineConfig
    for name, temp in (("greedy", 0.0), ("seeded", 0.8)):
        eng = Engine(EngineConfig(path=path, temperature=temp, seed=5,
                                  seq_len=SEQ, mode="pallas", tp=2,
                                  prefill_chunk=16, decode_chunk=8))
        want["engine_" + name] = eng.generate("the cat in the hat",
                                              max_tokens=SEQ).ids
    return _results(ctx, d, 2), want


def test_tp2_ranks_load_their_shard(tiny_tp2):
    """load_params(tp=2, rank=r) reads rank r's shard of the checkpoint:
    the tensors params_from_jax carries across from the JAX tp pytree."""
    got, _ = tiny_tp2
    for out in got:
        assert out["shard_equal"] == sorted(layout.TP_SHARDED_KEYS)


@pytest.mark.parametrize("name", [m[0] for m in R.FWD_MODES])
def test_tp2_forward_matches_jax(tiny_tp2, name):
    """Logits (whole on every rank), and each rank's K and V heads."""
    got, want = tiny_tp2
    wl, wk, wv = want["fwd_" + name]
    tol = 2e-4 if name == "fuse" else 2e-5
    for rank, out in enumerate(got):
        lg, k, v = out["fwd_" + name]
        assert lg.shape == (2, 1, 512)
        _close(lg, _np(wl), tol)
        _close(k, _heads(wk, rank, 2), 2e-5)
        _close(v, _heads(wv, rank, 2), 2e-5)
    assert torch.equal(got[0]["fwd_" + name][0], got[1]["fwd_" + name][0])


def test_tp2_decode_step_matches_jax(tiny_tp2):
    got, want = tiny_tp2
    for out in got:
        _close(out["step"], _np(want["step"]), 2e-5)


def test_tp2_single_stream_chunk_matches_jax(tiny_tp2):
    got, want = tiny_tp2
    for out in got:
        np.testing.assert_array_equal(out["chunk"].numpy(),
                                      _np(want["chunk"]))


@pytest.mark.parametrize("name", ["greedy", "seeded"])
def test_engine_tp2_matches_jax(tiny_tp2, name):
    """Engine(tp=2) completions equal the JAX engine's at tp 2 (greedy and
    seeded at t 0.8), on both ranks."""
    got, want = tiny_tp2
    assert len(want["engine_" + name]) > 40
    for out in got:
        assert out["engine_" + name] == want["engine_" + name]


# -- world: tiny at (dp 2, tp 2), and (dp 2, tp 1) ------------------------


def _jax_serve(path, prompts, kv_dtype="int8", max_batch=4):
    from qwen3_tpu.runtime.batched import BatchedEngine, Request

    eng = BatchedEngine(path, max_batch=max_batch, seq_len=SEQ, mode="pallas",
                        temperature=0.0, prefill_bucket=16, decode_chunk=8,
                        kv_dtype=kv_dtype)
    reqs = [eng.submit(Request(prompt=q, seed=i, max_tokens=10))
            for i, q in enumerate(prompts)]
    eng.run()
    return [r.prompt_ids + r.out_ids for r in reqs]


@pytest.fixture(scope="module")
def tiny_dp2(tmp_path_factory):
    from qwen3_tpu.models import init_kv_cache
    from qwen3_tpu.runtime.batched import prefill_slot_chunk
    from qwen3_tpu.runtime.decode_loop import burn_and_sample
    from qwen3_tpu.runtime.xorshift import seed_to_device

    d = tmp_path_factory.mktemp("dp2")
    w = _jax_weights("tiny", 3)
    path = _write(d, "tiny", w)
    mesh, params = _placed(w, 2, 2)
    _save_pytree(d, "jax_tp2.npz", params)
    ctx = launch.spawn_ranks(R.world_tiny_dp2_tp2, 4, (str(d),),
                             device="cpu")

    cfg, B = w.config, 4
    want = {}
    toks = jnp.asarray(R.block_tokens(B).numpy(), jnp.int32)
    kv = jtp.init_sharded_kv(cfg, B, SEQ, jnp.float32, mesh)
    lg, k, v = jtp.make_tp_forward(mesh, cfg, params, kv, mode="pallas")(
        params, toks, kv[0], kv[1], jnp.int32(0), jnp.int32(T - 1))
    want["fwd"] = tuple(map(_np, (lg, k, v)))
    step = jtp.make_tp_decode_step(mesh, cfg, params, (k, v), mode="pallas")
    want["step"] = step(params, jnp.arange(B, dtype=jnp.int32) + 5, k, v,
                        jnp.asarray([T + b % 2 for b in range(B)],
                                    jnp.int32))[0]

    pre = jtp.make_tp_prefill_slot_chunk(mesh, cfg, params, kv, mode="pallas")
    statics = dict(mode="pallas", chunk=R.CHUNK, greedy=True, bos=0, eos=1,
                   top_k=0, use_side=False)
    chunk = jtp.make_tp_batched_chunk(mesh, cfg, params, kv, **statics)
    k, v = jtp.init_sharded_kv(cfg, B, SEQ, jnp.float32, mesh)
    token, his, los = [], [], []
    for b in range(B):
        lg, k, v = pre(params, k, v, jnp.asarray(R.slot_prompt(b), jnp.int32),
                       jnp.int32(b), jnp.int32(0), jnp.int32(T - 1))
        h0, l0 = seed_to_device(b + 1)
        tok, h, l = burn_and_sample(lg, h0, l0, jnp.int32(0),
                                    jnp.float32(1e-6), jnp.float32(0.9),
                                    greedy=True, top_k=0)
        token.append(tok[0])
        his.append(h)
        los.append(l)
    full = lambda x, dt: jnp.full((B,), x, dt)    # noqa: E731
    want["batched_chunk"] = _np(chunk(
        params, k, v, jnp.stack(token), full(T, jnp.int32),
        full(T + R.CHUNK, jnp.int32), full(False, jnp.bool_),
        jnp.stack(his), jnp.stack(los), full(1e-6, jnp.float32),
        full(0.9, jnp.float32), full(False, jnp.bool_))[0])[:, :R.CHUNK]

    # the owner's logits, against the single device's slot prefill
    single = jtp.place_params(jtp.tp_host_params(w, 1), jax_mesh(
        1, 1, devices=jax.devices()[:1]), cfg.head_dim, SEQ)
    single = {k2: (v2[0] if k2 in jtp.TP_SHARDED_KEYS else v2)
              for k2, v2 in single.items()}
    k, v = init_kv_cache(cfg, B, SEQ)
    for c, base in enumerate((2, 40)):
        lg, k, v = prefill_slot_chunk(
            single, k, v, jnp.arange(base, base + T, dtype=jnp.int32),
            jnp.int32(B - 1), jnp.int32(c * T), jnp.int32(T - 1), cfg=cfg,
            mode="pallas")
    want["owner"] = lg

    admit = jtp.make_tp_prefill_slots_chunk(mesh, cfg, params, kv,
                                            mode="pallas")
    k, v = jtp.init_sharded_kv(cfg, B, SEQ, jnp.float32, mesh)
    rows = [R.slot_prompt(0), [0] * T, R.slot_prompt(3), [0] * T]
    lg, _, _ = admit(params, k, v, jnp.asarray(rows, jnp.int32),
                     jnp.asarray([0, 1, 3, 2], jnp.int32),
                     jnp.asarray([True, False, True, False]), jnp.int32(0),
                     jnp.asarray([T - 1, 0, T - 1, 0], jnp.int32))
    want["admit"] = _np(lg)[[0, 2]]
    want["serve"] = _jax_serve(path, R.PROMPTS)

    # the single-rank port
    port = {"serve": R._serve(path, R.PROMPTS)[1],
            "admission": R._serve(path, R.ADMIT, max_batch=8)[1],
            "chat": R._chat(path),
            "dp_only": R._serve(path, R.PROMPTS[:2], kv_dtype="float32",
                                max_batch=2)[1]}
    return _results(ctx, d, 4), want, port


def test_dp2_tp2_forward_and_step_match_jax(tiny_dp2):
    got, want, _ = tiny_dp2
    wl, wk, wv = want["fwd"]
    for rank, out in enumerate(got):
        dpi, tpi = divmod(rank, 2)
        rows = slice(2 * dpi, 2 * dpi + 2)
        lg, k, v = out["fwd"]
        _close(lg, _np(wl)[rows], 2e-5)
        _close(k, _heads(wk, tpi, 2, rows), 2e-5)
        _close(v, _heads(wv, tpi, 2, rows), 2e-5)
        _close(out["step"], _np(want["step"])[rows], 2e-5)


def test_dp2_tp2_batched_chunk_matches_jax(tiny_dp2):
    """The slot prefill and the batched chunk on the mesh: the packed ids,
    whole on every rank (gathered over dp each step)."""
    got, want, _ = tiny_dp2
    for out in got:
        np.testing.assert_array_equal(out["batched_chunk"],
                                      want["batched_chunk"])


def test_dp2_tp2_continuation_owner_logits(tiny_dp2):
    """Two chunks into slot 3, owned by dp shard 1: every rank gets the
    owner's logits (a broadcast from the owner)."""
    got, want, _ = tiny_dp2
    for out in got:
        _close(out["owner"], _np(want["owner"]), 2e-4)


def test_dp2_tp2_admission_routes_and_masks(tiny_dp2):
    """Batched admission with one padding row a shard: the valid rows'
    logits are JAX's, and the padding row left its slot as it was."""
    got, want, _ = tiny_dp2
    for out in got:
        _close(out["admit"], want["admit"], 2e-5)
        assert out["admit_pad_untouched"]


@pytest.mark.parametrize("what", ["serve", "admission", "chat"])
def test_batched_engine_on_mesh_matches_single(tiny_dp2, what):
    """BatchedEngine(tp=2, dp=2) streams, a 7-request admission through the
    gathered-slots program (a padding row on the underfull shard) and three
    BatchedChat conversations (slot 2 on dp shard 1) equal the single-rank
    port's, on every rank; the single rank's serve streams are JAX's."""
    got, want, port = tiny_dp2
    for out in got:
        assert out[what] == port[what]
    if what == "serve":
        assert port["serve"] == want["serve"]
    if what == "admission":
        assert all("prefill_slots" in out["admission_kinds"] for out in got)


def test_batched_engine_dp_only_mesh(tiny_dp2):
    got, _, port = tiny_dp2
    for out in got[:2]:
        assert out["dp_only"] == port["dp_only"]


# -- world: tiny8 at tp 4 and tp 8 ----------------------------------------


@pytest.fixture(scope="module")
def tiny8(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp48")
    w = _jax_weights("tiny8", 11)
    path = _write(d, "tiny8", w)
    placed = {}
    for dp, tp in ((2, 4), (1, 8)):
        placed[dp, tp] = _placed(w, dp, tp)
        _save_pytree(d, f"jax_tp{tp}.npz", placed[dp, tp][1])
    ctx = launch.spawn_ranks(R.world_tiny8, 8, (str(d),), device="cpu")
    want = {"serve": _jax_serve(path, R.PROMPTS)}
    for (dp, tp), (mesh, params) in placed.items():
        kv = jtp.init_sharded_kv(w.config, 2 * dp, SEQ, jnp.float32, mesh)
        toks = jnp.asarray(R.block_tokens(2 * dp).numpy(), jnp.int32)
        want[dp, tp] = jtp.make_tp_forward(mesh, w.config, params, kv,
                                           mode="pallas")(
            params, toks, kv[0], kv[1], jnp.int32(0), jnp.int32(T - 1))
    return _results(ctx, d, 8), want


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_tp48_forward_matches_jax(tiny8, dp, tp):
    got, want = tiny8
    wl, wk, _ = want[dp, tp]
    for rank, out in enumerate(got):
        dpi, tpi = divmod(rank, tp)
        rows = slice(2 * dpi, 2 * dpi + 2)
        lg, k = out[f"fwd_{dp}_{tp}"]
        _close(lg, _np(wl)[rows], 3e-5)
        _close(k, _heads(wk, tpi, tp, rows), 2e-5)


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_batched_engine_tp48_matches_single(tiny8, dp, tp):
    """The serving streams at tp 4 and tp 8 equal the single-device JAX
    engine's, on every rank."""
    got, want = tiny8
    for out in got:
        assert out[f"serve_{dp}_{tp}"] == want["serve"]

