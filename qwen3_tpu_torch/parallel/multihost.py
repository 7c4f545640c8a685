"""Processes joined by hand (qwen3_tpu/parallel/multihost.py's contract).

Every process runs the same command; `--coordinator ADDR:PORT
--num-processes P --process-id i` joins them into one torch.distributed
world through `tcp://ADDR:PORT` (process 0 listens there). Where a JAX
process drives every device of its host, a process here drives one card
(rank i takes card i % the host's cards), so the CLI asks for as many
processes as tp ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from qwen3_tpu_torch.parallel.launch import init_rank
from qwen3_tpu_torch.parallel.sharding import make_mesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda") -> None:
    """Join the world through the coordinator: init_process_group with
    init_method tcp://coordinator_address, world_size num_processes and
    rank process_id (parallel/launch.py::init_rank)."""
    init_rank(f"tcp://{coordinator_address}", num_processes, process_id,
              device)


def global_mesh(tp: int | None = None, device="cuda"):
    """A (dp, tp) mesh over every process of the world, tp contiguous
    (default tp: the world, at most 8)."""
    n = dist.get_world_size()
    if tp is None:
        tp = min(8, n)
    return make_mesh(dp=n // tp, tp=tp, device=device)


def is_primary() -> bool:
    """True on the process that owns stdout and stderr (every process runs
    the same program; one prints)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def agree_seed(seed: int) -> int:
    """Process 0's value, broadcast to every process. The CLI's default seed
    is the time, which differs between processes and would desync the
    replicated sampler state."""
    t = torch.tensor([seed], dtype=torch.int64)
    dist.broadcast(t, 0)
    return int(t[0])
