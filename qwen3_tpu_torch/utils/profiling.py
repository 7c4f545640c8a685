"""Profiling hooks: the program's spans, and the device trace around them.

The counterpart of qwen3_tpu/utils/profiling.py. The reference's only
instrumentation is wall-clock pp/tg counters (src/completion.c:307-340);
those live on in GenerationResult/TurnMetrics. For kernel-level analysis
this wraps torch.profiler: the Chrome trace it writes opens in Perfetto or
chrome://tracing and shows each kernel's device time beside the host ops
that launched it, and beside the program's own spans.

`SPANS` records the spans of the serving engine's layers (runtime/
batched.py, runtime/decode_loop.py, parallel/comm.py): off by default, on
from `SPANS.start()` to `SPANS.stop()`. A span is its name, its start and
end on `time.perf_counter_ns()` (the clock of `time.perf_counter`, in
integer nanoseconds), the index of the span it ran inside, the request id
(`Request.rid`, or a tuple of them) where it serves requests, and, for a
span given counters, their values at its end. Spans of one request share
its id. The list stays in memory until the recording stops.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import torch

# the annotation each end of a profile_trace brackets with the host clock
ANCHOR = "qwen3_tpu_torch.clock_anchor"
# spans that time a wait, not the host's work (recorded by SpanRecorder.add)
WAITS = ("queue",)


class Span(NamedTuple):
    name: str
    start: int                  # time.perf_counter_ns()
    end: int
    parent: int | None          # index of the enclosing span in the list
    rid: int | tuple | None     # the request(s) it serves
    counts: dict | None         # counters' values at its end, if given


class SpanRecorder:
    """The program's span recorder (see the module docstring).

        sid = SPANS.begin("step")
        ...
        SPANS.end(sid)

    Off, `begin` returns None and `end(None)` returns: a flag check each,
    no clock read, nothing allocated (a `with` statement would allocate its
    bound `__exit__` on every use). A span that an exception may leave is
    ended in a `finally`; ending a span ends every span still open inside
    it at the same time."""

    __slots__ = ("on", "clock", "_spans", "_open")

    def __init__(self):
        self.on = False
        self.clock = time.perf_counter_ns
        self._spans: list[list] = []
        self._open: list[int] = []

    def start(self) -> None:
        """Record from now on, into an empty list."""
        self._spans, self._open = [], []
        self.on = True

    def stop(self) -> list[Span]:
        """Stop recording; returns what was recorded, and keeps none of
        it."""
        self.on = False
        out = self.spans()
        self._spans, self._open = [], []
        return out

    def spans(self) -> list[Span]:
        """The spans recorded so far (an open span has end 0)."""
        return [Span(*s) for s in self._spans]

    def begin(self, name: str, rid=None, counts: dict | None = None,
              start: int | None = None) -> int | None:
        """Open span `name` inside the innermost open span; returns its id
        (None while off). `counts`: a dict of counters whose values the
        span keeps at its end. `start`: the caller's own clock read (ns),
        taken for a field that times the same interval."""
        if not self.on:
            return None
        sid = len(self._spans)
        parent = self._open[-1] if self._open else None
        self._spans.append([name, self.clock() if start is None else start,
                            0, parent, rid, counts])
        self._open.append(sid)
        return sid

    def end(self, sid: int | None, t: int | None = None) -> None:
        """End span `sid` (and any still open inside it) now, or at the
        caller's own clock read `t` (ns)."""
        if sid is None or sid not in self._open:
            return
        t = self.clock() if t is None else t
        while self._open:
            s = self._spans[self._open.pop()]
            s[2] = t
            if s[5] is not None:
                s[5] = dict(s[5])
            if s is self._spans[sid]:
                break

    def add(self, name: str, start: int, end: int, rid=None) -> None:
        """A span timed by the caller's clock reads, inside no other: a
        wait, such as a request's time in the queue, which encloses none of
        the host's work."""
        if self.on:
            self._spans.append([name, start, end, None, rid, None])


SPANS = SpanRecorder()


ANCHOR_SYNCS = 16      # device synchronizes in an anchor on the card


def _anchor(cuda: bool) -> list[tuple[int, int]]:
    """One ANCHOR annotation, holding host clock reads (ns) around each of
    ANCHOR_SYNCS bare device synchronizes on the card (around nothing on
    the CPU); returns the reads."""
    if cuda:
        torch.cuda.init()
    reads = []
    with torch.profiler.record_function(ANCHOR):
        for _ in range(ANCHOR_SYNCS if cuda else 1):
            t0 = time.perf_counter_ns()
            if cuda:
                torch._C._cuda_synchronize()
            reads.append((t0, time.perf_counter_ns()))
    return reads


def clock_line(pairs: list[tuple[float, float]]):
    """A function placing a perf_counter_ns time on a trace's clock (us),
    through anchors given as (host ns, trace ns) pairs: an offset from one,
    the line through the first and last from more. None without a pair."""
    if not pairs:
        return None
    (h0, m0), (h1, m1) = pairs[0], pairs[-1]
    rate = (m1 - m0) / (h1 - h0) if h1 != h0 else 1.0
    return lambda t: (m0 + (t - h0) * rate) / 1e3


def trace_clock(events: list, groups: list[list[tuple[int, int]]]):
    """clock_line for a Chrome trace holding one ANCHOR annotation for each
    group of host reads (ns) in `groups`, in order. On the card each
    synchronize event inside an annotation lies inside its reads once
    placed on the trace's clock, which bounds the offset from both sides:
    the anchor takes the middle of the tightest bounds (a read that also
    holds the runtime's own set-up bounds loosely, and the others decide).
    On the CPU the annotation's middle pairs with its one read's."""
    marks = sorted((e["ts"], e.get("dur", 0)) for e in events
                   if e.get("name") == ANCHOR and e.get("ph") == "X")
    syncs = sorted((e["ts"], e.get("dur", 0)) for e in events
                   if e.get("name") == "cudaDeviceSynchronize")
    pairs = []
    for reads, (ts, d) in zip(groups, marks):
        inner = [(s, sd) for s, sd in syncs if ts <= s and s + sd <= ts + d]
        host = (reads[0][0] + reads[-1][1]) / 2
        if len(inner) == len(reads):
            lo = max((s + sd) * 1e3 - b
                     for (s, sd), (_, b) in zip(inner, reads))
            hi = min(s * 1e3 - a for (s, _), (a, _) in zip(inner, reads))
            pairs.append((host, host + (lo + hi) / 2))
        else:
            pairs.append((host, (ts + d / 2) * 1e3))
    return clock_line(pairs)


def span_events(spans: list[Span], to_us, pid) -> list[dict]:
    """Chrome trace events of `spans` on the trace's clock `to_us`
    (trace_clock): the host's nested spans on one track, the waits (WAITS)
    on another."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": label}}
           for tid, label in ((1, "program spans"), (2, "program waits"))]
    for i, s in enumerate(spans):
        if not s.end:
            continue
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": 2 if s.name in WAITS else 1,
                    "ts": to_us(s.start),
                    "dur": to_us(s.end) - to_us(s.start),
                    "args": {"id": i, "parent": s.parent,
                             "rid": (list(s.rid) if isinstance(s.rid, tuple)
                                     else s.rid)}})
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """Trace the enclosed block (host ops, and the card's kernels when
    `device` is a CUDA device) into `log_dir`/<time>.<pid>.pt.trace.json;
    yields that path. The program's spans of the block are recorded too and
    written into the trace on tracks of their own, on the trace's clock:
    the host clock is read around the synchronizes of an annotation at
    each end, and the spans are placed on the line through the two
    (trace_clock).

    Usage:
        with profile_trace("/tmp/trace"):
            engine.generate(...)
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{time.strftime('%Y_%m_%d_%H_%M_%S')}."
                                 f"{os.getpid()}.pt.trace.json")
    was_on = SPANS.on
    if not was_on:
        SPANS.start()
    first = len(SPANS._spans)
    try:
        with profile(activities=activities) as prof:
            groups = [_anchor(cuda)]
            yield path
            groups.append(_anchor(cuda))
    finally:
        spans = SPANS.spans()[first:]
        if not was_on:
            SPANS.stop()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    to_us = trace_clock(trace["traceEvents"], groups)
    if to_us is not None:
        # indices and parents relative to the block's first span
        spans = [s._replace(parent=None if s.parent is None
                            or s.parent < first else s.parent - first)
                 for s in spans]
        trace["traceEvents"] += span_events(spans, to_us, os.getpid())
        with open(path, "w") as f:
            json.dump(trace, f)
