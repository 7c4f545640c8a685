"""Modes exact and bf16 on a (dp, tp) mesh of ranks (qwen3_tpu_torch/
parallel/sharding.py) against the JAX package's single-device forward, as
tests/test_sharding.py holds the JAX package's GSPMD-sharded forward: full
parameter dicts (carried across from the JAX pytree by params_from_jax)
sliced by shard_params, the KV cache by shard_kv_cache, and the forward
with the tp group's two reductions a layer.

Tolerances are tests/test_sharding.py's: logits within 2e-4 (rtol and
atol), the written K rows within 1e-5. The ranks run tests/
torch_tp_ranks.py::world_sharding, spawned over gloo on the CPU.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from qwen3_tpu.models import forward, init_kv_cache, init_params  # noqa: E402
from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as tq  # noqa: E402
from qwen3_tpu_torch.parallel import (  # noqa: E402
    kv_partition_spec,
    launch,
    make_mesh,
    param_partition_specs,
    shard_kv_cache,
)
from qwen3_tpu_torch.parallel.sharding import (  # noqa: E402
    Mesh,
    choose_backend,
)

MODES = ("bf16", "exact")


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_weights, tiny_cfg):
    d = tmp_path_factory.mktemp("sharding")
    params = {m: init_params(tiny_weights, mode=m) for m in MODES}
    for m in MODES:
        torch.save(tq.params_from_jax(
            {k: np.asarray(v) for k, v in params[m].items()}, tiny_cfg,
            device="cpu"), d / f"port_{m}.pt")
    ctx = launch.spawn_ranks(R.world_sharding, 4, (str(d),), device="cpu")
    want = {}
    for m in MODES:
        toks = jnp.asarray([[1, 2, 3, 4], [9, 8, 7, 6]], jnp.int32)
        k, v = init_kv_cache(tiny_cfg, 2, 64)
        lg, k, _ = forward(params[m], tiny_cfg, toks, k, v, jnp.int32(0),
                           mode=m, all_logits=True)
        want[m + "_block"] = (np.asarray(lg), np.asarray(k)[:, :, :4])
        k, v = init_kv_cache(tiny_cfg, 1, 64)
        want[m + "_token"] = np.asarray(forward(
            params[m], tiny_cfg, jnp.asarray([[5]], jnp.int32), k, v,
            jnp.int32(0), mode=m)[0])
    t0 = time.monotonic()
    while not ctx.join(timeout=1):
        assert time.monotonic() - t0 < 300, "the ranks did not finish"
    got = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    return got, want


def test_mesh_shapes():
    """A mesh without a process group is (1, 1); more ranks need one."""
    mesh = make_mesh(dp=1, tp=1, device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.rank == 0
    assert mesh.tp_group is None and mesh.dp_group is None
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(dp=2, tp=2, device="cpu")
    m = Mesh(dp=2, tp=4, rank=6, device=torch.device("cpu"), backend="gloo")
    assert (m.dp_idx, m.tp_idx) == (1, 2)
    m = Mesh(1, 2, 1, torch.device("cpu"), "gloo")
    assert (m.dp_idx, m.tp_idx) == (0, 1)


def test_backend_rule():
    """NCCL only when every rank has a card of its own."""
    assert choose_backend([("h", "cuda:0"), ("h", "cuda:1")]) == "nccl"
    assert choose_backend([("a", "cuda:0"), ("b", "cuda:0")]) == "nccl"
    assert choose_backend([("h", "cuda:0"), ("h", "cuda:0")]) == "gloo"
    assert choose_backend([("h", "cpu"), ("h", "cpu")]) == "gloo"


@pytest.mark.parametrize("mode", MODES)
def test_partition_specs_cover_the_params(tiny_weights, mode):
    """Every leaf of the mode's parameters has a split dimension (or none),
    and the KV cache splits its batch over dp and kv heads over tp."""
    p = tq.params_from_jax({k: np.asarray(v) for k, v in init_params(
        tiny_weights, mode=mode).items()}, PRESETS["tiny"], device="cpu")
    specs = param_partition_specs(mode)
    assert set(p) == set(specs)
    assert kv_partition_spec() == (1, 3)
    kv = tq.init_kv_cache(PRESETS["tiny"], 4, 16, "int8", "cpu")
    mesh = Mesh(dp=2, tp=2, rank=3, device=torch.device("cpu"),
                backend="gloo")
    (kq, ks), _ = shard_kv_cache(kv, mesh)
    assert kq.shape == (2, 2, 16, 1, 32) and ks.shape == (2, 2, 16, 1)
    torch.testing.assert_close(kq, kv[0][0][:, 2:, :, 1:])


@pytest.mark.parametrize("mode", MODES)
def test_tp_dp_logits_match_single_device(world, mode):
    """tp 2 (kv heads split) x dp 2 (batch split) reproduce the single
    device's logits of every position, and each rank's K rows."""
    got, want = world
    wl, wk = want[mode + "_block"]
    for rank, out in enumerate(got):
        dpi, tpi = divmod(rank, 2)
        lg, k = out[mode + "_block"]
        np.testing.assert_allclose(lg.numpy(), wl[dpi:dpi + 1], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(
            k.numpy(), wk[:, dpi:dpi + 1, :, tpi:tpi + 1], rtol=1e-5,
            atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_decode_step_sharded(world, mode):
    got, want = world
    for out in got[:2]:
        np.testing.assert_allclose(out[mode + "_token"].numpy(),
                                   want[mode + "_token"], rtol=2e-4,
                                   atol=2e-4)
    assert all(mode + "_token" not in out for out in got[2:])
