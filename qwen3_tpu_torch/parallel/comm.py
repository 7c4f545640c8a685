"""The collectives of the tensor- and data-parallel programs.

The JAX package reduces with `lax.psum` and gathers with `lax.all_gather`
inside `shard_map`; here one process runs one rank, and a `Group` is one
axis of the mesh (its ranks' `torch.distributed` process group).

Every reduction sums in rank order: the group all-gathers the partials and
adds them one after another on each rank. The bits then follow neither
NCCL's nor gloo's own reduction algorithm, every rank holds the same sum,
and at two ranks the sum is exactly `a + b`, as JAX's psum gives it. At
decode a reduction moves `size x dim x 4` bytes.

Transport: NCCL takes the device tensors as they are. gloo runs its
collectives on host tensors here: a CUDA tensor is copied to the host, the
collective runs there, and the result is copied back (gloo's own CUDA
paths stage through the host as well; this keeps one route for every
collective). Nothing falls back from one backend to the other: a failed
collective raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from qwen3_tpu_torch.utils.profiling import SPANS

# collectives launched through a Group (every rank counts its own) and the
# bytes this rank contributed; each is also a `collective` span
# (utils/profiling.py::SPANS), the host's time in the call: under NCCL its
# enqueue, not the transfer
COUNTS = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    COUNTS.update(calls=0, bytes=0)


class Group:
    """One axis of the mesh: the global ranks in it, in order, and the
    process group over them. `index` is this rank's place in the axis."""

    def __init__(self, ranks, pg, backend: str):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.pg = pg
        self.backend = backend
        self.index = self.ranks.index(dist.get_rank())

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks}, backend={self.backend!r})"

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's x, in rank order."""
        sid = SPANS.begin("collective")
        x = x.contiguous()
        COUNTS["calls"] += 1
        COUNTS["bytes"] += x.numel() * x.element_size()
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, x, group=self.pg)
        else:
            h = x.cpu()
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=self.pg)
            out = torch.stack(parts).to(x.device)
        SPANS.end(sid)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis, added in rank order (see the module
        docstring); the same bits on every rank."""
        parts = self.gather(x)
        out = parts[0]
        for i in range(1, self.size):
            out = out + parts[i]
        return out

    def cat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' x concatenated along `dim`, in rank order (the JAX
        package's tiled all_gather)."""
        return torch.cat(self.gather(x).unbind(0), dim=dim)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """x of the rank at index `src` of this axis, on every rank."""
        sid = SPANS.begin("collective")
        COUNTS["calls"] += 1
        COUNTS["bytes"] += x.numel() * x.element_size()
        x = x.contiguous()
        root = self.ranks[src]
        if self.backend == "nccl":
            dist.broadcast(x, root, group=self.pg)
            out = x
        else:
            h = x.cpu()
            dist.broadcast(h, root, group=self.pg)
            out = h.to(x.device)
        SPANS.end(sid)
        return out
