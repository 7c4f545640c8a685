"""Profiling hooks.

The counterpart of qwen3_tpu/utils/profiling.py. The reference's only
instrumentation is wall-clock pp/tg counters (src/completion.c:307-340);
those live on in GenerationResult/TurnMetrics. For kernel-level analysis
this wraps torch.profiler: the Chrome trace it writes opens in Perfetto or
chrome://tracing and shows each kernel's device time beside the host ops
that launched it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """Trace the enclosed block (host ops, and the card's kernels when
    `device` is a CUDA device) into `log_dir`/<time>.<pid>.pt.trace.json;
    yields that path.

    Usage:
        with profile_trace("/tmp/trace"):
            engine.generate(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{time.strftime('%Y_%m_%d_%H_%M_%S')}."
                                 f"{os.getpid()}.pt.trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
