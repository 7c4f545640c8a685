"""The port's DMA probe (qwen3_tpu_torch/tools/probe_dma.py): the plain
checksum that both pure-read kernels compute against the JAX probe's
Pallas kernels tools/probe_dma.py::pure_read_stacked and
::pure_read_manual, run under pltpu.force_tpu_interpret_mode() on the same
bytes, rearranged from the port's [L, d, n] to the JAX [L, J, n, td]
tiles. The checksums are integer sums, so they are equal exactly. The CUDA
kernels against the plain version are in test_torch_cuda.py."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from qwen3_tpu_torch.tools import probe_dma as pd  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_dma", REPO / "tools" / "probe_dma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_layout(w: np.ndarray, td: int) -> np.ndarray:
    """[L, d, n] -> [L, J, n, td]: tile jj holds rows jj * td .. + td - 1."""
    L, d, n = w.shape
    return np.ascontiguousarray(
        w.reshape(L, d // td, td, n).transpose(0, 1, 3, 2))


# (L, d, n): two column tiles of td = 1024 over two k-tiles, and a layer of
# five k-tiles as qwen3-4b's w13 has (n = 2560)
SHAPES = [(2, 2048, 1024), (2, 1024, 2560)]


@pytest.mark.parametrize("shape", SHAPES)
def test_pure_read_plain_matches_jax(jax_probe, shape):
    L, d, n = shape
    rng = np.random.default_rng(d + n)
    w = rng.integers(-128, 128, size=shape).astype(np.int8)
    td, tk = pd.probe_tiles(d, n)
    wt = jnp.asarray(_jax_layout(w, td))
    assert wt.shape == (L, d // td, n, td)
    for layer in range(L):
        got = pd.pure_read_plain(torch.from_numpy(w), layer).numpy()
        assert got.shape == (8, td) and got.dtype == np.int32
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_probe.pure_read_stacked(wt, layer))
            np.testing.assert_array_equal(got, want)
            for n_buf in pd.N_BUFS:
                want = np.asarray(jax_probe.pure_read_manual(wt, layer,
                                                             n_buf))
                np.testing.assert_array_equal(got, want)
        # the CPU wrappers are the plain version
        t = torch.from_numpy(w)
        assert torch.equal(pd.pure_read_stacked(t, layer), torch.from_numpy(got))
        assert torch.equal(pd.pure_read_manual(t, layer, 3),
                           torch.from_numpy(got))


def test_probe_tiles_are_the_jax_probes():
    """td = _pick_tile(d, 128, 1024), tk = _pick_tile(n, 512, 512): qwen3-4b's
    w13 [19456, 2560] reads in 19 x 5 tiles of [512, 1024]."""
    assert pd.probe_tiles(19456, 2560) == (1024, 512)
    assert pd.probe_tiles(512, 128) == (512, 128)
    with pytest.raises(ValueError):
        pd.pure_read_manual(torch.zeros(1, 128, 512, dtype=torch.int8), 0, 5)


def test_probe_main_on_cpu(monkeypatch, capsys):
    """The probe's entry point with --device cpu at the tiny preset: the
    per-layer size line and its five rows."""
    monkeypatch.setattr(pd, "PRESET", "tiny")
    monkeypatch.setattr(pd, "N_ITERS", 4)
    assert pd.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("w13_q per-layer bytes:")
    labels = [ln[:24].strip() for ln in lines[1:]]
    assert labels == ["q8q8 stacked matmul", "pure-read same walk",
                      "manual DMA 2-buffer", "manual DMA 3-buffer",
                      "manual DMA 4-buffer"]
    assert all(ln.endswith("GB/s") for ln in lines[1:])
