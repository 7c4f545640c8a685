"""The JAX package's own serving tests (tests/test_batched.py) run on the
port, on the CPU (the kernels' plain versions): the port's single-stream
Engine and ChatSession are the oracles where the JAX tests use the JAX
package's. The port's Engine decodes with per-slot KV writes (the JAX
engine's decode_impl="slot"), so the comparisons with it run the batched
engine without the side buffer, as the JAX test with decode_impl="slot"
does; the side buffer is held to the scatter path instead.

No JAX here: the checkpoint comes from the port's own IO."""

import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu_torch.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu_torch.runtime import batched as B  # noqa: E402
from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request  # noqa: E402
from qwen3_tpu_torch.runtime.batched_chat import BatchedChat  # noqa: E402
from qwen3_tpu_torch.runtime.chat import ChatSession  # noqa: E402
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402

PROMPTS = ["the cat", "in the hat and", "er on at", "the the the", "and er"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops, which gain nothing from
    intra-op threads and lose much to them when the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = PRESETS["tiny"]
    path = str(tmp_path_factory.mktemp("serving_port") / "tiny.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=1234))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


def _engine(ckpt, **kw):
    args = dict(max_batch=3, seq_len=96, mode="pallas-fast",
                temperature=0.0, top_p=0.9, prefill_bucket=16,
                decode_chunk=8, kv_dtype="int8", device="cpu")
    args.update(kw)
    return BatchedEngine(ckpt, **args)


def _single(ckpt, prompt, seed, temperature, max_tokens, mode="pallas-fast",
            top_p=0.9, seq_len=96):
    eng = Engine(EngineConfig(path=ckpt, seed=seed, temperature=temperature,
                              top_p=top_p, seq_len=seq_len, mode=mode,
                              prefill_chunk=16, decode_chunk=8,
                              kv_dtype="int8", device="cpu"))
    return eng.generate(prompt, max_tokens=max_tokens).ids


@pytest.mark.parametrize("mode", ["pallas", "pallas-fast"])
def test_batched_chat_matches_chat_session(ckpt, mode):
    """Two interleaved multi-turn conversations and a completion request
    on one slot pool, without the side buffer: each conversation's replies
    are bit-equal to a ChatSession of its own with the same seed
    (template, RNG burn, KV continuation)."""
    turns = ["the cat", "in the hat and er", "on at the the"]

    def single(seed, system):
        eng = Engine(EngineConfig(path=ckpt, seed=seed, temperature=0.8,
                                  top_p=0.9, seq_len=96, mode=mode,
                                  prefill_chunk=16, decode_chunk=8,
                                  kv_dtype="int8", device="cpu"))
        session = ChatSession(eng, system_prompt=system)
        return [session.send(t) for t in turns]

    beng = _engine(ckpt, mode=mode, temperature=0.8, side_buffer=False)
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
    assert got_a == single(11, "sys a")
    assert got_b == single(22, None)


def test_batched_chat_overflow_resets(ckpt):
    """Turns past the context: the conversation resets its position and
    keeps producing the ChatSession's streams."""
    turns = ["the cat in the hat", "er on at the", "and the thinker"]
    eng = Engine(EngineConfig(path=ckpt, seed=9, temperature=0.0,
                              top_p=0.9, seq_len=48, mode="pallas-fast",
                              prefill_chunk=16, decode_chunk=8,
                              kv_dtype="int8", device="cpu"))
    session = ChatSession(eng)
    want = [session.send(t) for t in turns]
    chat = BatchedChat(_engine(ckpt, max_batch=2, seq_len=48,
                               side_buffer=False))
    conv = chat.new_conversation(seed=9)
    got = [chat.send(conv, t) for t in turns]
    assert conv.last_stop in ("eos", "limit")
    assert got == want


@pytest.mark.parametrize("side", [True, False])
def test_batched_admission_matches_serial(ckpt, monkeypatch, side):
    """Fresh prompts with the same block plan prefill in one [N, C] forward
    per block (counted); their streams equal serial admission's (the
    admission KV budget at 0 forces one request a forward)."""
    calls = {"batch": 0, "serial": 0}
    orig_b, orig_s = B.prefill_slots_chunk, B.prefill_slot_chunk

    def count_b(*a, **kw):
        calls["batch"] += 1
        return orig_b(*a, **kw)

    def count_s(*a, **kw):
        calls["serial"] += 1
        return orig_s(*a, **kw)

    monkeypatch.setattr(B, "prefill_slots_chunk", count_b)
    monkeypatch.setattr(B, "prefill_slot_chunk", count_s)
    # long prompts -> 2 blocks at bucket 16; the same plan groups them
    prompts = [" ".join(["the cat in a hat er on at"] * 3) + f" {i}"
               for i in range(3)]

    def run():
        eng = _engine(ckpt, temperature=0.9, side_buffer=side)
        reqs = [eng.submit(Request(prompt=p, seed=40 + i, max_tokens=10))
                for i, p in enumerate(prompts)]
        eng.run()
        return [r.prompt_ids + r.out_ids for r in reqs]

    batched = run()
    assert calls["batch"] >= 2 and calls["serial"] == 0, calls
    monkeypatch.setattr(B, "ADMIT_KV_BYTES", 0)
    calls.update(batch=0, serial=0)
    assert run() == batched
    assert calls["batch"] == 0 and calls["serial"] >= 6, calls
    if not side:
        for i, p in enumerate(prompts):
            assert batched[i] == _single(ckpt, p, 40 + i, 0.9, 10)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_side_buffer_matches_scatter_path(ckpt, kv_dtype):
    """The chunk side buffer (uniform-step writes, two-segment attention,
    per-chunk merge) serves the same streams as per-step scatter writes."""
    def run(side):
        eng = _engine(ckpt, temperature=0.9, kv_dtype=kv_dtype,
                      side_buffer=side, attn="dense")
        reqs = [eng.submit(Request(prompt=p, seed=7 + i, max_tokens=20))
                for i, p in enumerate(PROMPTS)]
        eng.run()
        return [r.prompt_ids + r.out_ids for r in reqs]

    assert run(True) == run(False)


@pytest.mark.parametrize("attn", ["fused", "dense"])
def test_side_buffer_merge_at_seq_len_edge(ckpt, attn):
    """Slots decoding right up to seq_len merge their chunk windows into
    the cache's padding rows without corrupting live rows: every stream
    equals the single-stream engine's within this engine's limit."""
    eng = _engine(ckpt, max_batch=2, seq_len=32, attn=attn)
    reqs = [eng.submit(Request(prompt=p, seed=i))   # no max_tokens
            for i, p in enumerate(PROMPTS[:3])]
    assert len(eng.run()) == 3
    for r in reqs:
        assert r.finished
        got = r.prompt_ids + r.out_ids
        assert len(got) <= 32
        want = _single(ckpt, r.prompt, r.seed, 0.0, None)
        assert got == want[:len(got)]


def test_per_request_sampler_params(ckpt):
    """Greedy and sampled requests with their own temperature and top_p in
    one batch each equal the single-stream engine with that sampler."""
    configs = [(0.0, 0.9), (0.9, 0.9), (0.7, 0.5), (0.0, 1.0), (1.3, 0.95)]
    eng = _engine(ckpt, temperature=0.4, top_p=0.8, side_buffer=False)
    reqs = [eng.submit(Request(prompt=PROMPTS[i], seed=100 + i,
                               max_tokens=12, temperature=t, top_p=p))
            for i, (t, p) in enumerate(configs)]
    eng.run()
    for i, req in enumerate(reqs):
        t, p = configs[i]
        want = _single(ckpt, PROMPTS[i], 100 + i, t, 12, top_p=p)
        assert req.prompt_ids + req.out_ids == want, (i, t, p)
        assert req.prompt_ms > 0 and req.generate_ms > 0


def test_streaming_callback(ckpt):
    chunks = []
    eng = _engine(ckpt, max_batch=2, decode_chunk=4)
    eng.submit(Request(prompt="the cat", seed=1, max_tokens=8,
                       stream_cb=chunks.append))
    [req] = eng.run()
    assert b"".join(chunks) == eng.tokenizer.decode(req.out_ids)


def test_all_slots_pinned_raises_not_livelocks(ckpt):
    """A completion request that no free slot can take (every slot pinned
    by a conversation) raises instead of spinning."""
    eng = _engine(ckpt, max_batch=1)
    chat = BatchedChat(eng)
    conv = chat.new_conversation(seed=1)
    eng.submit(Request(prompt="the cat", seed=2, max_tokens=4))
    with pytest.raises(RuntimeError, match="pinned"):
        eng.run()
    chat.close(conv)
    [req] = eng.run()      # admissible once the pin drops
    assert req.finished


def test_more_requests_than_slots_all_finish(ckpt):
    eng = _engine(ckpt, max_batch=2)
    reqs = [eng.submit(Request(prompt=p, seed=i, max_tokens=6))
            for i, p in enumerate(PROMPTS * 2)]
    done = eng.run()
    assert len(done) == len(reqs)
    assert all(r.finished for r in reqs)


def test_engine_resolves_attention_as_the_jax_engine_does(ckpt, tmp_path):
    """auto: fused with the side buffer, dense without; flash only for one
    slot at a context of 8192 or more. fused without the side buffer and
    the compile-cache knob are refused, and the mesh without a process
    group; mode bf16 runs."""
    import dataclasses

    assert _engine(ckpt).attn == "fused"
    assert _engine(ckpt, side_buffer=False).attn == "dense"
    cfg = dataclasses.replace(PRESETS["tiny"], seq_len=8192)
    deep = str(tmp_path / "deep.bin")
    write_checkpoint(deep, synthetic_weights(cfg, seed=1))
    write_tokenizer_bin(deep + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    eng = _engine(deep, max_batch=1, seq_len=8192)
    assert eng.attn == "flash" and eng._kv[0][0].shape[2] == 8448
    with pytest.raises(ValueError, match="side buffer"):
        _engine(ckpt, attn="fused", side_buffer=False)
    with pytest.raises(NotImplementedError, match="not ported"):
        _engine(ckpt, aot_dir=str(tmp_path))
    # tp/dp > 1 run one process a rank: without a process group they raise
    # (tests/test_torch_tp.py runs them), and keep the JAX engine's checks
    for kw in (dict(tp=2), dict(dp=2, max_batch=4)):
        with pytest.raises(RuntimeError, match="process group"):
            _engine(ckpt, **kw)
    with pytest.raises(ValueError, match="divide over dp"):
        _engine(ckpt, max_batch=3, dp=2)
    with pytest.raises(ValueError, match="pallas"):
        _engine(ckpt, mode="bf16", tp=2)
    # mode bf16, refused before it was ported, runs
    eng = _engine(ckpt, mode="bf16")
    req = eng.submit(Request(prompt="the cat", seed=1, max_tokens=4))
    assert eng.run() == [req] and len(req.out_ids) <= 4
