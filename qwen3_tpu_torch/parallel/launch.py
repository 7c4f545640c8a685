"""Starting the ranks of a tensor- or data-parallel run: one process a rank.

The JAX package drives every device of a host from one process. Here each
rank is a process of its own: the CLI's `--tp N`, serve.py's `--tp/--dp`
and the tests start them with `torch.multiprocessing` (spawn: forking a
process that has initialized CUDA fails), and `--coordinator` joins
processes started by hand (parallel/multihost.py).

Every rank joins one default process group over gloo, whatever its device:
the hosts' control traffic (the seed, chat input, the ranks' agreement)
runs there. The mesh's own groups take the backend rule of
parallel/sharding.py (NCCL when every rank has a card of its own). Rank r
runs on card r % (the host's cards). Nothing falls back: a failed init or
collective raises, and no rank moves to the CPU on its own.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import threading

import torch
import torch.distributed as dist

# how long a rank waits in one collective before it raises (a rank that
# died leaves the others waiting here)
TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prepare(device) -> None:
    """Work for the parent before it starts the ranks: for a CUDA run,
    build the kernels once (ops/cuda/build.py), so that the ranks load the
    library instead of each building it."""
    if torch.device(device).type == "cuda":
        from qwen3_tpu_torch.ops.cuda import build

        build.ensure_built()


def init_rank(init_method: str, world: int, rank: int, device) -> None:
    """Pin this rank's card (rank % the host's cards) for a CUDA run, or one
    intra-op thread for a CPU one, and join the default process group."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def ranks_agree(obj) -> bool:
    """Whether every rank of the world holds an equal `obj` (a collective:
    every rank calls it)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return all(o == objs[0] for o in objs)


def silence() -> None:
    """Send this process's stdout and stderr (the file descriptors, so
    native writes too) to /dev/null: rank 0 owns the terminal."""
    null = os.open(os.devnull, os.O_WRONLY)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(null, 1)
    os.dup2(null, 2)
    os.close(null)


def _child(i: int, first: int, fn, world: int, init_method: str, device,
           args: tuple) -> None:
    """A spawned rank (rank `first + i`). Its failure reaches the parent
    with its traceback through torch.multiprocessing's error file."""
    rank = first + i
    silence()
    init_rank(init_method, world, rank, device)
    try:
        rc = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def spawn_ranks(fn, world: int, args: tuple = (), *, device="cuda",
                init_method: str | None = None, first: int = 0):
    """Start ranks first.. world - 1, each calling fn(rank, *args) once it
    has joined the default group, silent; returns the torch.multiprocessing
    context without waiting (its join() raises with a failed rank's
    traceback). `fn` is pickled by its import path, so it lives in a module
    the ranks can import."""
    from torch import multiprocessing as mp

    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    return mp.start_processes(
        _child, args=(first, fn, world, init_method, device, args),
        nprocs=world - first, join=False, start_method="spawn")


def run_ranks(fn, world: int, args: tuple = (), *, device="cuda") -> int:
    """Run fn(rank, *args) on `world` ranks: rank 0 in this process (it
    owns stdin, stdout and stderr), ranks 1.. spawned, silent. Returns the
    worst exit code of the ranks; a rank that fails makes the whole run
    exit at once with its traceback on this process's stderr (the others
    would wait in their collectives)."""
    from torch.multiprocessing.spawn import ProcessException

    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = spawn_ranks(fn, world, args, device=device,
                      init_method=init_method, first=1)
    stopping = threading.Event()

    def watch():
        try:
            while not ctx.join(timeout=0.5):
                pass
        except ProcessException as e:
            if stopping.is_set():          # rank 0 failed and stops them
                return
            rc = getattr(e, "exit_code", 1) or 1
            print(f"[Launch] rank {e.error_index + 1} failed:\n{e}",
                  file=sys.stderr, flush=True)
            sys.stdout.flush()
            os._exit(rc if rc > 0 else 1)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        init_rank(init_method, world, 0, device)
        rc = fn(0, *args)
    except BaseException:
        # a rank that failed first takes its peers' collectives down with
        # it: give the watcher the moment it needs to report that rank;
        # else this rank's own error stops the others
        watcher.join(timeout=2)
        stopping.set()
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    watcher.join()
    rcs = [rc or 0] + [p.exitcode or 0 for p in ctx.processes]
    return max(rcs, key=abs)
