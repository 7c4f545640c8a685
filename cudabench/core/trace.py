"""The traced sub-window: torch.profiler over whole decode chunks.

The measured window runs without the profiler. Once it has closed and
every request submitted in it has its first token, the profiler starts
and runs for `chunks` more bursts of deliveries, so that the sub-window
holds whole chunks with their boundaries' admissions at the window's load.
The trace goes to a file under TMPDIR, is read back and deleted. What is
read: every device operation (kernels, copies, sets) with its start and
length, the runtime calls the host made beside them, the device's busy
time (the union of its operations), the device operations that took most
time and the idle gaps by the runtime call the host was in ("(python)"
where it was in none: launching from Python), and the program's counters
at both ends.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without `void`, an anonymous namespace, its
    template arguments and its parameters: `void (anonymous namespace)::
    k<(anonymous namespace)::T>(int)` -> `k`."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


@dataclasses.dataclass
class Trace:
    """What the traced sub-window holds; readers take their numbers here."""
    window_s: float
    busy_s: float
    ops: list            # (short name, start s, seconds, category)
    device_ops: list     # [[name, seconds]], most time first
    idle_gaps: list      # [[host op, seconds]], most idle time first
    steps: int           # decode steps (the model module's counters())
    forwards: int        # prefill block forwards
    bursts: tuple        # (first, last) burst of the sub-window

    def seconds(self, names) -> float:
        """Device seconds of the operations whose short name is in
        `names`."""
        names = set(names)
        return sum(op[2] for op in self.ops if op[0] in names)

    def kernels(self) -> int:
        """Kernels launched in the sub-window (copies and sets apart)."""
        return sum(1 for op in self.ops if op[3] == "kernel")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(path: str) -> tuple[list, float, list, list]:
    """(device ops, busy seconds, top device ops, top idle gaps) of a
    Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e["ts"], e.get("dur", 0.0), e["name"], cat))
        elif cat in HOST_CATS:
            host.append((e["ts"], e.get("dur", 0.0), e["name"]))
    del events
    ops = [(short_name(n), ts * 1e-6, d * 1e-6, c) for ts, d, n, c in dev]
    merged = _union((ts, ts + d) for ts, d, _, _ in dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    by_name = collections.Counter()
    for n, _, d, _ in ops:
        by_name[n] += d
    top_ops = [[n, s] for n, s in by_name.most_common(TOP)]
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "(python)"
        # the innermost host op over the gap: the latest-starting one that
        # still runs at its middle
        for j in range(i, max(-1, i - 5000), -1):
            ts, d, n = host[j]
            if ts + d >= mid:
                name = n
                break
        idle[name] += (s1 - e0) * 1e-6
    top_idle = [[n, s] for n, s in idle.most_common(TOP)]
    return ops, busy, top_ops, top_idle


class Tracer:
    """Profiles `chunks` bursts of a ClosedLoop after its window; the
    loop serves on until it has them."""

    def __init__(self, loop, chunks: int, counters, cuda: bool):
        self.loop, self.chunks = loop, chunks
        self.counters, self.cuda = counters, cuda
        self.prof = None
        self.seen = 0
        self._t0 = self._t1 = self._c0 = self._c1 = None
        self._b0 = self._b1 = None
        loop.on_burst.append(self._hook)
        loop.holds.append(self._hold)

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def _hold(self, burst: int) -> bool:
        """Start at the first call (the window is served); hold the loop
        until the profiler has stopped."""
        if self.prof is None and self._t1 is None:
            from torch.profiler import ProfilerActivity, profile
            # on the card its activity alone, runtime calls included: the
            # CPU activity records every PyTorch op and slows the host that
            # paces the steps
            acts = [ProfilerActivity.CUDA if self.cuda
                    else ProfilerActivity.CPU]
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.start()
            self._c0, self._b0 = dict(self.counters()), burst
            self._t0 = time.perf_counter()
        return self._t1 is None

    def _hook(self, burst: int, t: float) -> None:
        if self.prof is not None and self._t1 is None:
            self.seen += 1
            if self.seen == self.chunks:
                self.stop(burst)

    def stop(self, burst: int) -> None:
        """Stop the profiler at `burst` (if it runs); its trace is read
        after the run, by `finish`."""
        if self.prof is None or self._t1 is not None:
            return
        self._sync()
        self._t1 = time.perf_counter()
        self._c1, self._b1 = dict(self.counters()), burst
        self.prof.stop()

    def finish(self) -> Trace | None:
        """Read the stopped profiler's trace (None if it never started)."""
        if self.prof is None:
            return None
        if self._t1 is None:
            self.stop(self.counters()["decode_forward"])
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            ops, busy, top_ops, top_idle = read(path)
        finally:
            os.unlink(path)
            self.prof = None
        return Trace(
            window_s=self._t1 - self._t0, busy_s=busy, ops=ops,
            device_ops=top_ops, idle_gaps=top_idle,
            steps=self._c1["decode_forward"] - self._c0["decode_forward"],
            forwards=self._c1["forward"] - self._c0["forward"],
            bursts=(self._b0, self._b1))
