"""The port's device-side synthetic parameters (io/device_synth.py) against
what they stand in for: the keys, shapes and dtypes of the port's
load_params(mode="pallas") on a checkpoint of the same configuration, and
the JAX package's packed_shapes under the layout change ([L, J, n, td]
tiles there, row-major [L, d, n] here: the same n, d = J * td save the
JAX classifier's zero padding to a multiple of 1024). Values are the
generator's, so the checks are on magnitudes and on a forward pass."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu.io.device_synth import packed_shapes as jax_shapes  # noqa: E402
from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu_torch.io.device_synth import (  # noqa: E402
    packed_shapes,
    synth_device_params,
)
from qwen3_tpu_torch.io.synthetic import synthetic_weights  # noqa: E402
from qwen3_tpu_torch.models import qwen3 as model  # noqa: E402


@pytest.mark.parametrize("preset", ["tiny", "tiny8"])
def test_synth_matches_load_params(tmp_path, preset):
    """Tied (tiny) and the 8-kv-head geometry; an untied classifier below."""
    cfg = PRESETS[preset]
    path = str(tmp_path / "m.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=0))
    _, want = model.load_params(path, mode="pallas", max_seq_len=64,
                                device="cpu")
    got = synth_device_params(cfg, 64, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        assert got[k].device == want[k].device, k
    assert got["cls_q"] is got["emb_q"]         # tied, as load_params
    assert torch.equal(got["rope_cos"], want["rope_cos"])
    shapes = packed_shapes(cfg)
    for k, (shape, dt) in shapes.items():
        assert tuple(got[k].shape) == shape
        assert str(got[k].dtype) == f"torch.{dt}"


def test_synth_untied_magnitudes_and_seed():
    """An untied classifier gets its own tensors; int8 in [-127, 127],
    scales in [0.5, 1.5) * scale / 127, norms about 1; one seed, one set of
    values; another seed, others."""
    import dataclasses

    cfg = dataclasses.replace(PRESETS["tiny"], shared_classifier=False)
    a = synth_device_params(cfg, 32, seed=1, device="cpu")
    b = synth_device_params(cfg, 32, seed=1, device="cpu")
    c = synth_device_params(cfg, 32, seed=2, device="cpu")
    assert a["cls_q"] is not a["emb_q"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["w13_q"], c["w13_q"])
    for k, v in a.items():
        if v.dtype == torch.int8:
            assert v.min() >= -127 and v.max() <= 127
        elif k.endswith("_s"):
            assert v.min() >= 0.5 * 0.02 / 127 and v.max() < 1.5 * 0.02 / 127
    assert abs(a["att_norm"].mean().item() - 1.0) < 0.1


@pytest.mark.parametrize("preset", ["tiny", "qwen3-0.6b", "qwen3-4b"])
def test_packed_shapes_match_jax_under_the_layout_change(preset):
    cfg = PRESETS[preset]
    ours, theirs = packed_shapes(cfg), jax_shapes(cfg)
    assert sorted(ours) == sorted(theirs)
    for k, (shape, dt) in ours.items():
        jshape, jdt = theirs[k]
        assert dt == jdt, k
        if len(jshape) == len(shape):                 # norms, embedding
            assert jshape == shape, k
            continue
        *lead, j, n, td = jshape                       # [.., J, n, td]
        *olead, d, on = shape                          # [.., d, n]
        assert lead == olead and n == on, k
        if k.startswith("cls_") and j * td != d:
            assert j * td == -(-d // 1024) * 1024, k   # JAX's zero padding
        else:
            assert j * td == d, k


def test_synth_forward_is_finite():
    cfg = PRESETS["tiny"]
    p = synth_device_params(cfg, 64, seed=0, device="cpu")
    k, v = model.init_kv_cache(cfg, 1, 64, "int8", "cpu")
    toks = torch.from_numpy(np.arange(8, dtype=np.int64)[None] % cfg.vocab_size)
    logits, _, _ = model.forward(p, cfg, toks, k, v, 0, all_logits=True)
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_synth_refuses_the_tpu_exec_cache():
    with pytest.raises(NotImplementedError):
        synth_device_params(PRESETS["tiny"], 8, device="cpu",
                            exec_cache="/nonexistent")
