"""The port's B = 1 decode chunk (runtime/decode_loop.py::decode_chunk)
against the JAX package's on preset tiny8 (8 kv heads, the real presets'
geometry; f32 KV), on the CPU (the JAX package's Pallas kernels in
interpret mode); test_torch_decode_chunk.py holds tiny.

The chunk cases are torch_chunk_parity.run_chunks: a 16-token prefill, then
chunks of 8 held equal after each. The prefill's token seed (0, and 3 for
the greedy exact flash case, FLIP_FREE) and the RNG seed (5) are ones where
no Q8 activation rounding flips between the packages on these inputs
(ROADMAP.md, Queue C #1)."""

import pytest

torch = pytest.importorskip("torch")

from torch_chunk_parity import (  # noqa: E402
    CHUNK,
    PROMPT,
    run_chunks,
    stop_inside_chunk,
)

# the prefill's token seed where seed 0 flips a Q8 activation
FLIP_FREE = {("exact", "flash", "greedy"): 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# each mode, attention and sampling twice (tiny runs all eight): every JAX
# configuration compiles anew
@pytest.mark.parametrize("mode,attn,sampling", [
    ("pallas", "dense", "greedy"), ("pallas", "flash", "seeded"),
    ("exact", "dense", "seeded"), ("exact", "flash", "greedy")])
def test_decode_chunk_matches_jax(mode, attn, sampling):
    """Two chunks against a limit at 16 + 8 + 5: the first runs free, the
    second meets the limit, which mode exact's cases emit (chat's
    emit_at_limit) and mode pallas's do not (completion)."""
    emit = mode == "exact"
    emitted = run_chunks("tiny8", mode, attn,
                         temperature=0.0 if sampling == "greedy" else 0.8,
                         limit=PROMPT + CHUNK + 5, emit_at_limit=emit,
                         chunks=3,
                         tok_seed=FLIP_FREE.get((mode, attn, sampling), 0))
    assert len(emitted) == CHUNK + 5 + emit


@pytest.mark.parametrize("mode", ["pallas", "exact"])
def test_decode_chunk_stop_inside_chunk_matches_jax(mode):
    stop_inside_chunk("tiny8", mode)
