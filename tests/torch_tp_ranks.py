"""The rank bodies of the tensor- and data-parallel CPU tests
(tests/test_torch_tp.py, test_torch_sharding.py): each runs in a rank
spawned by qwen3_tpu_torch/parallel/launch.py, so this module imports only
torch, numpy and the port, never JAX (not a test module: pytest puts
`tests/` on the path, and the spawned ranks find it there).

A world runs several checks on one set of ranks: every rank computes its
part, and writes what it got to `<dir>/rank<r>.pt` for the test process to
hold against the JAX package's programs. Inputs come from the test process
through `<dir>` (the JAX tp pytree as .npz, a checkpoint) and from the
formulas below, which the tests repeat on the JAX side.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from qwen3_tpu_torch.config import PRESETS
from qwen3_tpu_torch.models import qwen3 as tq
from qwen3_tpu_torch.parallel import make_mesh, shard_kv_cache, shard_params
from qwen3_tpu_torch.parallel import shard_layout as layout
from qwen3_tpu_torch.parallel import tp as ptp
from qwen3_tpu_torch.runtime import batched as rb
from qwen3_tpu_torch.runtime.batched import BatchedEngine, Request
from qwen3_tpu_torch.runtime.batched_chat import BatchedChat
from qwen3_tpu_torch.runtime.decode_loop import burn_and_sample
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig
from qwen3_tpu_torch.runtime.xorshift import to_device_state

SEQ = 64
T = 8                         # prefill block rows
CHUNK = 6                     # the batched chunk's steps
PROMPTS = ["the cat", "in the hat and", "er on at", "the the"]
ADMIT = [f"the cat {i}" for i in range(7)]
TURNS = [["the cat", "a hat on"], ["on at the", "er at"],
         ["in the er", "the the at"]]
FWD_MODES = (("pallas", "pallas", False), ("fast", "pallas-fast", False),
             ("int8", "pallas-int8", False), ("fuse", "pallas", True))


def cfg_of(preset: str):
    return dataclasses.replace(PRESETS[preset], seq_len=SEQ)


def block_tokens(B: int) -> torch.Tensor:
    """The forward tests' [B, T] block (qwen3_tpu tests/test_tp.py)."""
    return (torch.arange(B * T) % 101).reshape(B, T)


def slot_prompt(b: int) -> list[int]:
    return [(7 * b + i) % 101 + 2 for i in range(T)]


def _rows(x, mesh, B):
    """The rank's dp share of a [B, ...] batch."""
    bl = B // mesh.dp
    return x[mesh.dp_idx * bl:(mesh.dp_idx + 1) * bl]


def _forward(mesh, cfg, p, B, mode="pallas", fuse=False, kv="float32"):
    loc = layout.local_config(cfg, mesh.tp)
    k, v = tq.init_kv_cache(loc, B // mesh.dp, SEQ, kv, "cpu")
    fwd = ptp.make_tp_forward(mesh, cfg, mode=mode, fuse=fuse)
    return fwd(p, _rows(block_tokens(B), mesh, B), k, v, 0, T - 1)


def _decode_step(mesh, cfg, p, B):
    """A prefill block, then one serving step at ragged positions."""
    _, k, v = _forward(mesh, cfg, p, B)
    step = ptp.make_tp_decode_step(mesh, cfg, mode="pallas")
    toks = torch.arange(B) + 5
    pos = torch.tensor([T + (b % 2) for b in range(B)])
    lg, _, _ = step(p, _rows(toks, mesh, B), k, v, _rows(pos, mesh, B))
    return lg


def _serve(path, prompts, kv_dtype="int8", **kw):
    eng = BatchedEngine(path, max_batch=kw.pop("max_batch", 4), seq_len=SEQ,
                        mode="pallas", temperature=0.0, prefill_bucket=16,
                        decode_chunk=8, kv_dtype=kv_dtype, device="cpu", **kw)
    reqs = [eng.submit(Request(prompt=q, seed=i, max_tokens=10))
            for i, q in enumerate(prompts)]
    eng.run()
    assert all(r.finished for r in reqs)
    return eng, [r.prompt_ids + r.out_ids for r in reqs]


def _chat(path, **kw):
    eng = BatchedEngine(path, max_batch=4, seq_len=SEQ, mode="pallas",
                        temperature=0.0, prefill_bucket=8, decode_chunk=4,
                        device="cpu", **kw)
    chat = BatchedChat(eng)
    convs = [chat.new_conversation(seed=10 + i) for i in range(3)]
    outs = []
    for t in range(2):
        reqs = [chat.submit_turn(c, TURNS[i][t]) for i, c in enumerate(convs)]
        eng.run()
        for c, r in zip(convs, reqs):
            chat.finish_turn(c, r)
        outs.append([bytes(eng.tokenizer.decode(r.out_ids)) for r in reqs])
    return outs


def _save(d: Path, rank: int, out: dict) -> None:
    torch.save(out, d / f"rank{rank}.pt")


def world_tiny_tp2(rank: int, d: str) -> None:
    """tiny at (dp 1, tp 2): the shard function, the forward in four
    variants, a decode step, the single-stream chunk, Engine(tp=2)."""
    d = Path(d)
    cfg = cfg_of("tiny")
    mesh = make_mesh(dp=1, tp=2, device="cpu")
    jp = dict(np.load(d / "jax_tp2.npz"))
    p = tq.params_from_jax(jp, cfg, device="cpu", rank=mesh.tp_idx)
    _, mine = tq.load_params(str(d / "tiny.bin"), "pallas", max_seq_len=SEQ,
                             device="cpu", tp=2, rank=mesh.tp_idx)
    out = {"shard_equal": sorted(k for k in layout.TP_SHARDED_KEYS
                                 if torch.equal(mine[k], p[k]))}
    for name, mode, fuse in FWD_MODES:
        lg, k, v = _forward(mesh, cfg, p, 2, mode, fuse)
        out["fwd_" + name] = (lg, k[:, :, :T], v[:, :, :T])
    out["step"] = _decode_step(mesh, cfg, p, 2)
    chunk = ptp.make_tp_decode_chunk(
        mesh, cfg, mode="pallas", chunk=8, temperature=1e-6, top_p=0.9,
        greedy=True, bos=0, eos=1, emit_at_limit=False, top_k=0,
        attn="dense")
    k, v = tq.init_kv_cache(layout.local_config(cfg, 2), 1, SEQ, "float32",
                            "cpu")
    hi, lo = to_device_state(3, torch.device("cpu"))
    out["chunk"] = chunk(p, k, v, torch.tensor([7]), 0, SEQ, hi, lo)[0]
    for name, temp in (("greedy", 0.0), ("seeded", 0.8)):
        eng = Engine(EngineConfig(
            path=str(d / "tiny.bin"), temperature=temp, seed=5, seq_len=SEQ,
            mode="pallas", tp=2, prefill_chunk=16, decode_chunk=8,
            device="cpu"))
        out["engine_" + name] = eng.generate("the cat in the hat",
                                             max_tokens=SEQ).ids
    _save(d, rank, out)


def world_tiny_dp2_tp2(rank: int, d: str) -> None:
    """tiny at (dp 2, tp 2): the forward and a decode step, the slot
    prefill and the batched chunk, the owner's logits of a continuation,
    batched admission with a padding row, BatchedEngine and BatchedChat;
    then (dp 2, tp 1) on ranks 0-1: pure data-parallel serving."""
    d = Path(d)
    cfg = cfg_of("tiny")
    ckpt = str(d / "tiny.bin")
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    jp = dict(np.load(d / "jax_tp2.npz"))
    p = tq.params_from_jax(jp, cfg, device="cpu", rank=mesh.tp_idx)
    loc = layout.local_config(cfg, 2)
    out = {}
    lg, k, v = _forward(mesh, cfg, p, 4)
    out["fwd"] = (lg, k[:, :, :T], v[:, :, :T])
    out["step"] = _decode_step(mesh, cfg, p, 4)

    # slot prefill (greedy first token) into every slot, then a chunk
    B = 4
    pre = ptp.make_tp_prefill_slot_chunk(mesh, cfg, mode="pallas")
    k, v = tq.init_kv_cache(loc, B // 2, SEQ, "float32", "cpu")
    token, rng = [], []
    for b in range(B):
        lg, k, v = pre(p, k, v, slot_prompt(b), b, 0, T - 1)
        tok, r = burn_and_sample(lg, b + 1, 0, 1e-6, 0.9, greedy=True)
        token.append(tok)
        rng.append(r)
    chunk = ptp.make_tp_batched_chunk(mesh, cfg, mode="pallas", chunk=CHUNK,
                                      greedy=True, bos=0, eos=1, top_k=0,
                                      use_side=False)
    packed = chunk(p, k, v, token, [T] * B, [T + CHUNK] * B, [False] * B,
                   rng, [1e-6] * B, [0.9] * B, [False] * B)[0]
    out["batched_chunk"] = packed[:, :CHUNK]

    # two chunks into slot 3, which dp shard 1 owns
    k, v = tq.init_kv_cache(loc, B // 2, SEQ, "float32", "cpu")
    for c, base in enumerate((2, 40)):
        lg, k, v = pre(p, k, v, list(range(base, base + T)), B - 1, c * T,
                       T - 1)
    out["owner"] = lg

    # batched admission: slots 0 and 2 (shard 0: slot 1 pads), 3 (shard 1:
    # slot 2 pads)
    admit = ptp.make_tp_prefill_slots_chunk(mesh, cfg, mode="pallas")
    k, v = tq.init_kv_cache(loc, B // 2, SEQ, "float32", "cpu")
    rows = [slot_prompt(0), [0] * T, slot_prompt(3), [0] * T]
    lg, k, v = admit(p, k, v, rows, [0, 1, 3, 2], [True, False, True, False],
                     0, [T - 1, 0, T - 1, 0])
    out["admit"] = lg[[0, 2]]
    pad = 1 - mesh.dp_idx             # local slot of the shard's pad row
    out["admit_pad_untouched"] = bool((k[:, pad].abs().sum() == 0).item())

    eng, out["serve"] = _serve(ckpt, PROMPTS, tp=2, dp=2)
    (eng, out["admission"]), out["admission_kinds"] = _admission_kinds(
        lambda: _serve(ckpt, ADMIT, max_batch=8, tp=2, dp=2))
    out["chat"] = _chat(ckpt, tp=2, dp=2)
    if mesh.rank < 2:
        out["dp_only"] = _serve(ckpt, PROMPTS[:2], kv_dtype="float32",
                                max_batch=2, dp=2, tp=1)[1]
    else:
        make_mesh(dp=2, tp=1, device="cpu")     # every rank makes the mesh
    _save(d, rank, out)


def _admission_kinds(run):
    """run()'s result and the admission programs it called:
    runtime.batched's mesh_prefill_slots_chunk ("prefill_slots", batched
    admission) and mesh_prefill_slot_chunk ("prefill", serial)."""
    seen = set()
    saved = {"prefill": rb.mesh_prefill_slot_chunk,
             "prefill_slots": rb.mesh_prefill_slots_chunk}

    def counted(kind):
        def fn(*args, **kwargs):
            seen.add(kind)
            return saved[kind](*args, **kwargs)
        return fn

    rb.mesh_prefill_slot_chunk = counted("prefill")
    rb.mesh_prefill_slots_chunk = counted("prefill_slots")
    try:
        result = run()
    finally:
        rb.mesh_prefill_slot_chunk = saved["prefill"]
        rb.mesh_prefill_slots_chunk = saved["prefill_slots"]
    return result, sorted(seen)


def world_tiny8(rank: int, d: str) -> None:
    """tiny8 on 8 ranks: the forward and BatchedEngine at (dp 2, tp 4) and
    at (dp 1, tp 8)."""
    d = Path(d)
    cfg = cfg_of("tiny8")
    out = {}
    for dp, tp in ((2, 4), (1, 8)):
        mesh = make_mesh(dp=dp, tp=tp, device="cpu")
        jp = dict(np.load(d / f"jax_tp{tp}.npz"))
        p = tq.params_from_jax(jp, cfg, device="cpu", rank=mesh.tp_idx)
        lg, k, _ = _forward(mesh, cfg, p, 2 * dp)
        out[f"fwd_{dp}_{tp}"] = (lg, k[:, :, :T])
        out[f"serve_{dp}_{tp}"] = _serve(str(d / "tiny8.bin"), PROMPTS,
                                         tp=tp, dp=dp)[1]
    _save(d, rank, out)


def world_sharding(rank: int, d: str) -> None:
    """Modes exact and bf16 on full parameter dicts (the port's, carried
    across from the JAX pytree by the test process) sliced by
    parallel.sharding: all logits of a [2, 4] block at (dp 2, tp 2), and
    one token at (dp 1, tp 2) on ranks 0-1."""
    d = Path(d)
    cfg = PRESETS["tiny"]
    loc = layout.local_config(cfg, 2)
    out = {}
    for mode in ("bf16", "exact"):
        full = torch.load(d / f"port_{mode}.pt")
        mesh = make_mesh(dp=2, tp=2, device="cpu")
        p = shard_params(full, cfg, mesh, mode)
        k, v = shard_kv_cache(tq.init_kv_cache(cfg, 2, 64, "float32", "cpu"),
                              mesh)
        toks = torch.tensor([[1, 2, 3, 4], [9, 8, 7, 6]])
        lg, k, _ = tq.forward(p, loc, _rows(toks, mesh, 2), k, v, 0,
                              mode=mode, all_logits=True, group=mesh.tp_group,
                              out_vocab=cfg.vocab_size)
        out[mode + "_block"] = (lg, k[:, :, :4])
        mesh = make_mesh(dp=1, tp=2, device="cpu")
        if rank < mesh.dp * mesh.tp:
            p = shard_params(full, cfg, mesh, mode)
            k, v = shard_kv_cache(tq.init_kv_cache(cfg, 1, 64, "float32",
                                                   "cpu"), mesh)
            fwd = ptp.make_tp_forward(mesh, cfg, mode=mode)
            out[mode + "_token"] = fwd(p, torch.tensor([[5]]), k, v, 0)[0]
    _save(d, rank, out)


def loaded_modules(rank: int, d: str) -> None:
    """The top-level modules a spawned rank has loaded, one a line."""
    import sys

    roots = sorted({m.split(".")[0] for m in sys.modules})
    (Path(d) / "modules.txt").write_text("\n".join(roots))


def fail_on_rank(rank: int, bad: int) -> None:
    """Rank `bad` raises; the others wait in a collective that only a
    launcher that stops the run on a failed rank ends."""
    import torch.distributed as dist

    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
