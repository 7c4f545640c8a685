"""The port stands alone: no module of `qwen3_tpu_torch/` (its `parallel/`
included), nor the root `chip_smoke.py` and `ab_trees.py`, nor the rank
bodies the tensor-parallel tests spawn (`tests/torch_tp_ranks.py`) imports
JAX, ml_dtypes or the JAX package; importing every port module, or running as a
spawned rank, leaves JAX unloaded; and asking for the card where there is
none raises instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "qwen3_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "qwen3_tpu")


RANKS = REPO / "tests" / "torch_tp_ranks.py"


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "ab_trees.py", RANKS]


def _module_names():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py") if p.name != "__main__.py")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


# the port's modules (packages included, __main__ excluded): a module that
# disappears, or fails to be found, lowers the count and fails the check;
# a new module raises it here
N_MODULES = 61


def test_importing_every_port_module_leaves_jax_unloaded():
    mods = _module_names()
    assert len(mods) == N_MODULES, mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_package_is_covered():
    """parallel/'s modules are among those imported above."""
    assert {m for m in _module_names() if ".parallel" in m} == {
        "qwen3_tpu_torch.parallel", "qwen3_tpu_torch.parallel.comm",
        "qwen3_tpu_torch.parallel.launch",
        "qwen3_tpu_torch.parallel.multihost",
        "qwen3_tpu_torch.parallel.shard_layout",
        "qwen3_tpu_torch.parallel.sharding", "qwen3_tpu_torch.parallel.tp"}


def test_sampler_kernel_and_tools_are_covered():
    """The sampler kernel's wrapper and the end-to-end and depth tools are
    among the modules imported above."""
    assert {"qwen3_tpu_torch.ops.cuda.sampler",
            "qwen3_tpu_torch.tools.e2e_8b",
            "qwen3_tpu_torch.tools.quality_depth"} <= set(_module_names())


def test_spawned_rank_leaves_jax_unloaded(tmp_path):
    """A rank spawned by parallel/launch.py (as the tensor-parallel tests
    spawn theirs, from this process, which has JAX loaded) runs with
    neither JAX nor the JAX package imported."""
    import time

    import torch_tp_ranks
    from qwen3_tpu_torch.parallel import launch

    ctx = launch.spawn_ranks(torch_tp_ranks.loaded_modules, 1,
                             (str(tmp_path),), device="cpu")
    t0 = time.monotonic()
    while not ctx.join(timeout=1):
        assert time.monotonic() - t0 < 120, "the rank did not finish"
    roots = set((tmp_path / "modules.txt").read_text().split())
    assert {"torch", "qwen3_tpu_torch", "torch_tp_ranks"} <= roots
    assert not roots & set(FORBIDDEN)


def test_cuda_engine_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from qwen3_tpu_torch.config import PRESETS
    from qwen3_tpu_torch.io.checkpoint import write_checkpoint
    from qwen3_tpu_torch.io.synthetic import (
        synthetic_tokenizer,
        synthetic_weights,
    )
    from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin
    from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = PRESETS["tiny"]
    path = str(tmp_path / "tiny.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=0))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    assert EngineConfig(path=path).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(EngineConfig(path=path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(EngineConfig(path=path, device="cuda"))


def test_chip_smoke_fails_without_a_card():
    """The chip script exits non-zero and prints no result line when
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
