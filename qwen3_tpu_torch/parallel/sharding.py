"""The (dp, tp) mesh over torch.distributed ranks, and the rank's slice of
each parameter and of the KV cache (qwen3_tpu/parallel/sharding.py's
contract).

The JAX package lays a (dp, tp) grid of devices out in one process and lets
GSPMD or shard_map place the shards. Here one process drives one rank: the
mesh is this rank's place in the grid, its card, and the process groups of
its two axes. A rank is placed at `rank = dp_idx * tp + tp_idx`, so the tp
ranks are contiguous, as make_mesh reshapes the devices to (dp, tp).

- attention is head-sharded over tp: q/k/v column-parallel (output
  features are heads), wo row-parallel (its input features), so a rank
  holds n_heads/tp query and n_kv_heads/tp KV heads and their KV cache;
- the FFN is column-parallel on w1/w3 and row-parallel on w2;
- the classifier is vocab-sharded over tp;
- the batch axis (and with it the KV cache's) is sharded over dp.

Backend: NCCL when every rank of the mesh has a card of its own; gloo when
ranks share a card (the only case on a one-card host) or run on the CPU.
The rule is decided from every rank's (host, device), gathered over the
default process group (gloo, see parallel/launch.py) before the mesh's
groups are made, and the mesh prints it with the rank-to-card map.
"""

from __future__ import annotations

import dataclasses
import socket

import torch
import torch.distributed as dist

from qwen3_tpu_torch.parallel.comm import Group
from qwen3_tpu_torch.parallel.shard_layout import tp_shard_params
from qwen3_tpu_torch.utils.logging import log


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, tp) grid. `tp_group`/`dp_group` are
    None where the axis has one rank (nothing to reduce)."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    backend: str
    tp_group: Group | None = None
    dp_group: Group | None = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_idx(self) -> int:
        return self.rank // self.tp

    @property
    def tp_idx(self) -> int:
        return self.rank % self.tp


def choose_backend(cards: list[tuple[str, str]]) -> str:
    """The backend rule: NCCL when every rank runs on a card of its own
    ((host, device) pairs all distinct, all CUDA), else gloo."""
    on_cuda = all(dev.startswith("cuda") for _, dev in cards)
    if on_cuda and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def _device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: int = 1, tp: int | None = None, device="cuda") -> Mesh:
    """The (dp, tp) mesh over the first dp * tp ranks of the world
    (default tp: world // dp). A (1, 1) mesh is this process alone, with
    no groups, and needs no process group. A larger one is a collective:
    every rank of the world must call it, in the same order as its other
    collectives, since it gathers the ranks' devices and makes the axes'
    process groups. A card rank runs on the card the launcher pinned
    (parallel/launch.py: rank % the host's cards)."""
    dev = _device_of(device)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if tp is None:
        tp = world // dp
    n = dp * tp
    if dp == tp == 1:
        return Mesh(1, 1, 0, dev, "none")
    if dp < 1 or tp < 1 or n > world:
        if not initialized:
            raise RuntimeError(
                f"a (dp={dp}, tp={tp}) mesh runs one process a rank, and "
                f"this process joined no process group: start the ranks "
                f"with the CLI's --tp, serve.py's --tp/--dp or "
                f"parallel.launch")
        raise ValueError(f"a (dp={dp}, tp={tp}) mesh needs {n} ranks; the "
                         f"world has {world}")
    cards = [None] * world
    dist.all_gather_object(cards, (socket.gethostname(), str(dev)))
    kinds = {d.split(":")[0] for _, d in cards[:n]}
    if len(kinds) != 1:
        raise ValueError(f"the mesh's ranks run on different device types: "
                         f"{cards[:n]}")
    backend = choose_backend(cards[:n])
    mesh = Mesh(dp, tp, rank, dev, backend)
    # every rank makes every group, in one order (new_group is collective)
    for d in range(dp if tp > 1 else 0):
        ranks = [d * tp + t for t in range(tp)]
        pg = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            mesh.tp_group = Group(ranks, pg, backend)
    for t in range(tp if dp > 1 else 0):
        ranks = [d * tp + t for d in range(dp)]
        pg = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            mesh.dp_group = Group(ranks, pg, backend)
    if rank == 0:
        where = " ".join(f"{r}->{d}@{h}" for r, (h, d) in enumerate(cards[:n]))
        log("Mesh", f"dp={dp} tp={tp} backend={backend} ranks {where}")
    return mesh


def param_partition_specs(mode: str = "bf16") -> dict[str, int | None]:
    """The split dimension over tp of each leaf of the exact and bf16
    layouts (None: replicated), keyed like models.qwen3's parameters."""
    specs: dict[str, int | None] = {
        k: None for k in ("att_norm", "ffn_norm", "out_norm", "q_norm",
                          "k_norm", "rope_cos", "rope_sin", "emb_q", "emb_s")}
    if mode == "exact":
        # int8 [L, out, in] / scales [L, out, in // G]
        for name in ("wq", "wk", "wv", "w1", "w3"):
            specs[name + "_q"] = specs[name + "_s"] = 1      # output features
        for name in ("wo", "w2"):
            # in // G splits evenly: (in / tp) % G == 0 (parallel/tp.check_tp)
            specs[name + "_q"] = specs[name + "_s"] = 2      # input features
        specs["cls_q"] = specs["cls_s"] = 0                  # vocab [V, D]
    elif mode == "bf16":
        # bf16 transposed [L, in, out]
        for name in ("wq", "wk", "wv", "w1", "w3"):
            specs[name + "_t"] = 2
        for name in ("wo", "w2"):
            specs[name + "_t"] = 1
        specs["cls_t"] = 1                                   # [D, V]
    else:
        raise ValueError(f"mode {mode!r}: the pallas modes shard by "
                         f"parallel.shard_layout.tp_shard_params")
    return specs


def kv_partition_spec() -> tuple[int, int]:
    """KV cache [L, B, S, KV, HD] (int8 scales [L, B, S, KV]): the batch
    dimension over dp and the kv-head dimension over tp, the same two
    dimensions in values and scales."""
    return 1, 3


def _split(a: torch.Tensor, dim: int, parts: int, i: int,
           pad: bool = False) -> torch.Tensor:
    """Part i of `parts` equal parts of a along dim (zero-padded up to a
    multiple of parts where `pad`), as a tensor of its own."""
    n = a.shape[dim]
    if pad and n % parts:
        shape = list(a.shape)
        shape[dim] = parts - n % parts
        a = torch.cat([a, a.new_zeros(shape)], dim=dim)
        n = a.shape[dim]
    if n % parts:
        raise ValueError(f"dimension {dim} ({n}) does not split into {parts}")
    w = n // parts
    return a.narrow(dim, i * w, w).clone()


def shard_params(params: dict, cfg, mesh: Mesh, mode: str = "bf16") -> dict:
    """This rank's slice (its tp index) of a full parameter dict of `mode`.
    The classifier's vocab is padded with zero rows (and zero scales) up
    to a multiple of tp, as the pallas pack does; the rope tables and the
    replicated leaves carry over as they are."""
    if mode not in ("exact", "bf16"):
        return tp_shard_params(params, cfg, mesh.tp, mesh.tp_idx)
    if mesh.tp == 1:
        return dict(params)
    specs = param_partition_specs(mode)
    return {k: (v if specs[k] is None else
                _split(v, specs[k], mesh.tp, mesh.tp_idx,
                       pad=k.startswith("cls_")))
            for k, v in params.items()}


def shard_kv_cache(kv, mesh: Mesh):
    """This rank's slice of a full cache (k, v): its dp rows of the batch,
    its tp share of the kv heads; int8 caches are (values, scales)."""
    b_dim, h_dim = kv_partition_spec()

    def one(t: torch.Tensor) -> torch.Tensor:
        t = _split(t, b_dim, mesh.dp, mesh.dp_idx)
        return _split(t, h_dim, mesh.tp, mesh.tp_idx)

    return tuple(tuple(one(t) for t in side) if isinstance(side, tuple)
                 else one(side) for side in kv)
