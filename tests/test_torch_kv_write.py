"""The port's per-slot KV row write (ops/cuda/kv_write.py::kv_write_rows,
whose plain version runs on the CPU) against the JAX package's Pallas
kernel qwen3_tpu/ops/pallas/kv_write.py::kv_write_rows in interpret mode,
with the cases of tests/test_kv_write.py: bit-equal for float32 and
bfloat16 caches (the row write is a cast; both round to nearest even). The
CUDA kernel against its plain version is in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3_tpu.ops.pallas.kv_write import kv_write_rows as jax_write  # noqa: E402
from qwen3_tpu_torch.ops.cuda import kv_write as kw  # noqa: E402

L, B, S, KV, D = 3, 8, 16, 2, 64
# duplicate positions across slots + edge rows
POSITIONS = [0, 3, 3, S - 1, 7, 0, S - 1, 5]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("layer", [0, L - 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_write_rows_matches_jax(dtype, layer):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    rows = rng.standard_normal((B, KV, D)).astype(np.float32)
    jcache = jnp.asarray(cache, jdt)
    want = _as_f32(jax_write(jcache, jnp.asarray(rows), jnp.int32(layer),
                             jnp.asarray(POSITIONS, jnp.int32),
                             interpret=True))
    tcache = torch.from_numpy(cache).to(tdt)
    got = kw.kv_write_rows(tcache, torch.from_numpy(rows), layer, POSITIONS)
    assert got is tcache                    # in place
    np.testing.assert_array_equal(got.float().numpy(), want)
    # untouched layers and rows preserved
    keep = np.ones((L, B, S), bool)
    keep[layer, np.arange(B), POSITIONS] = False
    np.testing.assert_array_equal(got.float().numpy()[keep],
                                  _as_f32(jcache)[keep])


def test_kv_write_rows_positions_and_refusals():
    """Positions may be a list or a tensor; an out-of-range one is clamped
    into [0, S) (the caller's contract, kept for memory safety); other
    dtypes, shapes and layers raise."""
    cache = torch.zeros(2, 2, 4, 1, 8)
    rows = torch.ones(2, 1, 8)
    kw.kv_write_rows(cache, rows, 1, torch.tensor([-3, 9]))
    assert cache[1, 0, 0].eq(1).all() and cache[1, 1, 3].eq(1).all()
    assert cache.sum() == 16
    with pytest.raises(TypeError):
        kw.kv_write_rows(cache.to(torch.int8), rows, 0, [0, 0])
    with pytest.raises(ValueError):
        kw.kv_write_rows(cache, rows[:1], 0, [0, 0])
    with pytest.raises(IndexError):
        kw.kv_write_rows(cache, rows, 2, [0, 0])
    with pytest.raises(ValueError):
        kw.kv_write_rows(cache, rows, 0, [0, 0, 0])


@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_write_rows_position_dtypes_match_jax(dtype, pos_dtype):
    """Positions as an int32 or int64 tensor (the kernel reads either as
    stored), edge and duplicate ones included, at both layers: the same
    cache as the JAX kernel's."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    rows = rng.standard_normal((B, KV, D)).astype(np.float32)
    for layer in (0, L - 1):
        want = _as_f32(jax_write(jnp.asarray(cache, jdt), jnp.asarray(rows),
                                 jnp.int32(layer),
                                 jnp.asarray(POSITIONS, jnp.int32),
                                 interpret=True))
        got = kw.kv_write_rows(torch.from_numpy(cache).to(tdt),
                               torch.from_numpy(rows), layer,
                               torch.tensor(POSITIONS, dtype=pos_dtype))
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_kv_write_rows_device_positions():
    """The kernel's positions: int32 and int64 tensors pass through as they
    are (no cast, no clamp: the kernel clamps), a list becomes a tensor on
    the device, another integer dtype is converted once to int32; floats
    and a wrong length raise."""
    cpu = torch.device("cpu")
    for dt in (torch.int32, torch.int64):
        pos = torch.tensor([-3, 9], dtype=dt)
        got = kw._device_positions(pos, 2, cpu)
        assert got is pos and got.dtype == dt
    got = kw._device_positions([0, 5], 2, cpu)
    assert got.dtype == torch.int64 and got.tolist() == [0, 5]
    got = kw._device_positions(torch.tensor([1, 2], dtype=torch.int16), 2,
                               cpu)
    assert got.dtype == torch.int32 and got.tolist() == [1, 2]
    with pytest.raises(TypeError):
        kw._device_positions(torch.tensor([0.0, 1.0]), 2, cpu)
    with pytest.raises(ValueError):
        kw._device_positions([0, 1, 2], 2, cpu)
