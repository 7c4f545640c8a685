"""The single-stream engine's decode programs (EngineConfig.decode_impl),
`reset(batch)` and `reset_rng()`:

- "fused" (runtime/decode_loop.py::decode_chunk): completion and chat
  streams equal to the JAX engine's decode_impl="fused" on a tiny synthetic
  checkpoint (mode pallas, int8 KV). The prompt and seeds are ones where no
  Q8 activation rounding flips between the packages (ROADMAP.md, Queue C
  #1), as in test_torch_engine.py;
- "side": bit-equal to the port's BatchedEngine(side_buffer=True), the
  serving default, as tests/test_batched.py holds the JAX engines (mode
  exact, where BatchedEngine's attn="auto" is dense, as the engine's)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu.runtime.chat import ChatSession as JaxChat  # noqa: E402
from qwen3_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from qwen3_tpu.runtime.engine import EngineConfig as JaxConfig  # noqa: E402
from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request  # noqa: E402
from qwen3_tpu_torch.runtime.batched_chat import BatchedChat  # noqa: E402
from qwen3_tpu_torch.runtime.chat import ChatSession  # noqa: E402
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402

PROMPT = "in the beginning"
PROMPTS = ["the cat", "in the hat and", "er on at", "the the the", "and er"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, tiny_weights, tiny_tok):
    d = tmp_path_factory.mktemp("torch_engine_programs")
    path = str(d / "tiny.bin")
    write_checkpoint(path, tiny_weights)
    write_tokenizer_bin(path + ".tokenizer", tiny_tok)
    return path


def _fused(ckpt, seed, temperature, **extra):
    return dict(path=ckpt, seed=seed, temperature=temperature, top_p=0.9,
                mode="pallas", kv_dtype="int8", decode_chunk=8,
                decode_impl="fused", **extra)


@pytest.mark.parametrize("seed,temperature", [(42, 0.0), (1, 0.8),
                                              (2, 0.8)])
def test_fused_completion_matches_jax(ckpt, seed, temperature):
    """Three chunks of 8 and a fourth that meets the max-token limit."""
    kw = _fused(ckpt, seed, temperature)
    want = JaxEngine(JaxConfig(**kw)).generate(PROMPT, max_tokens=28)
    eng = Engine(EngineConfig(device="cpu", **kw))
    got = eng.generate(PROMPT, max_tokens=28)
    assert got.ids == want.ids and got.text == want.text
    assert got.n_generated == want.n_generated
    # the engine carries the RNG on: a second completion continues the
    # stream; reset_rng() goes back to the seed
    eng.reset_rng()
    assert eng.generate(PROMPT, max_tokens=28).ids == want.ids


@pytest.mark.parametrize("seed", [9, 3])
def test_fused_chat_matches_jax(ckpt, seed):
    """Two turns at seq_len 64: the first runs to the context limit
    (emit_at_limit), the second starts with the overflow reset; the RNG
    carries across the turns. (Seed 7, which test_torch_engine.py's slot
    chat uses, flips a Q8 activation in the fused program's second turn.)"""
    kw = _fused(ckpt, seed, 0.8, seq_len=64)
    js = JaxChat(JaxEngine(JaxConfig(**kw)), system_prompt="be brief")
    ts = ChatSession(Engine(EngineConfig(device="cpu", **kw)),
                     system_prompt="be brief")
    for turn in ("hello", "why?"):
        assert ts.send(turn) == js.send(turn)
        assert ts.pos == js.pos and ts.last_stop == js.last_stop


def _side_engine(ckpt, seed, temperature, seq_len=96, **extra):
    return Engine(EngineConfig(
        path=ckpt, seed=seed, temperature=temperature, top_p=0.9,
        seq_len=seq_len, mode="exact", prefill_chunk=16, decode_chunk=8,
        decode_impl="side", device="cpu", **extra))


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_batched_matches_side_engine(ckpt, temp):
    """tests/test_batched.py::test_batched_matches_single_stream on the
    port: every request of a 2-slot BatchedEngine (side buffer) equals the
    single-stream engine's "side" program."""
    eng = BatchedEngine(ckpt, max_batch=2, seq_len=96, mode="exact",
                        temperature=temp, top_p=0.9, prefill_bucket=16,
                        decode_chunk=8, device="cpu")
    reqs = [eng.submit(Request(prompt=p, seed=100 + i, max_tokens=12))
            for i, p in enumerate(PROMPTS)]
    assert len(eng.run()) == len(PROMPTS)
    for i, req in enumerate(reqs):
        want = _side_engine(ckpt, 100 + i, temp).generate(
            PROMPTS[i], max_tokens=12).ids
        assert req.prompt_ids + req.out_ids == want, i


def test_batched_chat_matches_side_chat_session(ckpt):
    """tests/test_batched.py::test_batched_chat_matches_chat_session's side
    case on the port: two interleaved conversations on one slot pool equal
    dedicated ChatSessions on the "side" program."""
    turns = ["the cat", "in the hat and er", "on at the the"]

    def single(seed, system):
        eng = _side_engine(ckpt, seed, 0.8)
        session = ChatSession(eng, system_prompt=system)
        return [session.send(t) for t in turns]

    want_a, want_b = single(11, "sys a"), single(22, None)
    beng = BatchedEngine(ckpt, max_batch=3, seq_len=96, mode="exact",
                         temperature=0.8, top_p=0.9, prefill_bucket=16,
                         decode_chunk=8, device="cpu")
    chat = BatchedChat(beng)
    conv_a = chat.new_conversation(seed=11, system_prompt="sys a")
    conv_b = chat.new_conversation(seed=22)
    got_a, got_b = [], []
    for i, t in enumerate(turns):
        ra = chat.submit_turn(conv_a, t)
        rb = chat.submit_turn(conv_b, t)
        if i == 0:  # completion traffic shares the pool mid-conversation
            beng.submit(Request(prompt="the the", seed=5, max_tokens=6))
        beng.run()
        chat.finish_turn(conv_a, ra)
        chat.finish_turn(conv_b, rb)
        got_a.append(beng.tokenizer.decode(ra.out_ids))
        got_b.append(beng.tokenizer.decode(rb.out_ids))
    assert got_a == want_a
    assert got_b == want_b


def test_side_engine_at_the_seq_len_edge(ckpt):
    """tests/test_batched.py::test_side_buffer_merge_at_seq_len_edge on the
    port: slots decoding up to seq_len 32 equal the "side" engine's
    streams, which merge their last chunk window into the padding rows."""
    eng = BatchedEngine(ckpt, max_batch=2, seq_len=32, mode="exact",
                        temperature=0.0, prefill_bucket=16, decode_chunk=8,
                        device="cpu")
    reqs = [eng.submit(Request(prompt=p, seed=i))
            for i, p in enumerate(PROMPTS[:3])]
    assert len(eng.run()) == 3
    for r in reqs:
        got = r.prompt_ids + r.out_ids
        assert len(got) <= 32
        want = _side_engine(ckpt, r.seed, 0.0, seq_len=32).generate(
            r.prompt).ids
        assert got == want


def test_reset_batch_and_rows(ckpt):
    """reset(batch) allocates `batch` cache rows (EngineConfig.batch by
    default); the side program's cache has decode_chunk rows more, padded
    to 256 as the JAX engine's."""
    eng = _side_engine(ckpt, 0, 0.0, batch=3)
    eng.reset()
    assert eng._kv[0].shape[1:3] == (3, 256)
    eng.reset(batch=2)
    assert eng._kv[0].shape[1:3] == (2, 256)
    for impl, rows in (("side", 512), ("slot", 256), ("fused", 256)):
        eng = Engine(EngineConfig(path=ckpt, seq_len=128, mode="exact",
                                  decode_chunk=160, decode_impl=impl,
                                  device="cpu"))
        eng.reset(batch=1)
        assert eng._kv[0].shape[1:3] == (1, rows)


def test_decode_impl_default_and_refusal(ckpt):
    assert EngineConfig(path=ckpt).decode_impl == \
        JaxConfig(path=ckpt).decode_impl == "slot"
    with pytest.raises(ValueError, match="decode_impl"):
        Engine(EngineConfig(path=ckpt, decode_impl="scan", device="cpu"))


def test_fused_engine_on_cuda_raises_without_a_card(ckpt):
    """No fallback hides the device: the fused engine on "cuda" raises
    where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(EngineConfig(path=ckpt, decode_impl="fused"))


def test_programs_give_one_greedy_stream(ckpt):
    """slot, side and fused print the same greedy tokens here (the same
    math up to the attention's summation order)."""
    streams = [Engine(EngineConfig(
        path=ckpt, temperature=0.0, mode="pallas", kv_dtype="int8",
        decode_chunk=8, decode_impl=impl, device="cpu")).generate(
            PROMPT, max_tokens=20).ids for impl in ("slot", "side", "fused")]
    assert streams[0] == streams[1] == streams[2]
    assert len(np.unique([len(s) for s in streams])) == 1
