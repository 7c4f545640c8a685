"""The program's spans on the device trace's clock.

The port records spans of its serving engine (qwen3_tpu_torch/utils/
profiling.py::SPANS) on `time.perf_counter_ns()`; torch.profiler's Chrome
trace has a clock of its own. `AnchoredTracer` is core/trace.py's Tracer
with two clock anchors: just after the profiler starts and just before it
stops, the host clock is read around each of ANCHORS device synchronizes.
Each synchronize's `cudaDeviceSynchronize` runtime event lies inside its
host reads once placed on the trace's clock, which bounds the offset
between the clocks from both sides; an anchor's offset is the middle of
the tightest bounds of its synchronizes (a run of ANCHORS such events,
no other runtime call between them, at the trace's start or its end). A
span is placed on the line through the two anchors, whose offsets may
differ by the clocks' drift. So placed, each idle gap of the device that
lies in no runtime call, which core/trace.py names "(python)", is named
by the innermost program span over its middle, "(python) <span>", or
stays "(python)" where no span covers it; the parts add up to the
"(python)" total, and every other number of the Trace is core/trace.py's
own. The spans that time a wait (`queue`) enclose none of
the host's work and name no gap.

A program without the recorder (an older checkout) gets the offsets and
no split.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import sys
import time

from cudabench.core import trace

SYNC = "cudaDeviceSynchronize"
ANCHORS = 16            # synchronizes an anchor
READS = ("cudaStreamSynchronize", "cudaMemcpyAsync")
WAITS = ("queue",)
PYTHON = "(python)"


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from qwen3_tpu_torch.utils.profiling import SPANS
    except ImportError:
        return None
    return SPANS


def window_counts(loop, spans: list) -> dict | None:
    """The engine's counters (runtime/batched.py::COUNTS) over a closed
    loop's measured window: those the `chunk` span whose deliveries closed
    it kept at its end, less those of the chunk whose deliveries opened it
    (nothing is counted while a chunk delivers). None without them."""
    if loop.b_end is None or loop.t_end <= loop.t0:
        return None
    chunks = [s for s in spans if s.name == "chunk" and s.counts]

    def at(t):
        return next((s.counts for s in chunks
                     if s.start <= t * 1e9 <= s.end), None)
    c0, c1 = at(loop.t0), at(loop.t_end)
    if c0 is None or c1 is None:
        return None
    return {k: c1[k] - c0.get(k, 0) for k in c1}


def events_of(trace_events: list) -> tuple[list, list]:
    """(device intervals (ts, dur), host calls (ts, dur, name)) of a Chrome
    trace's events, in microseconds, as core/trace.py takes them."""
    dev, host = [], []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in trace.DEVICE_CATS:
            dev.append((e["ts"], e.get("dur", 0.0)))
        elif cat in trace.HOST_CATS:
            host.append((e["ts"], e.get("dur", 0.0), e["name"]))
    host.sort()
    return dev, host


def anchor(events: list, reads: list) -> tuple[float, float, float]:
    """(host ns, offset ns, the offset's uncertainty ns) of one anchor:
    synchronize events (ts, dur) in us, each inside its host reads (ns)
    once placed on the trace's clock. The offset (trace less host) is the
    middle of the tightest bounds they set; a negative uncertainty says the
    events and the reads do not match."""
    lo = max((ts + d) * 1e3 - b for (ts, d), (_, b) in zip(events, reads))
    hi = min(ts * 1e3 - a for (ts, _), (a, _) in zip(events, reads))
    return (reads[0][0] + reads[-1][1]) / 2, (lo + hi) / 2, hi - lo


def anchors(host: list, groups: list) -> list[tuple[float, float, float]]:
    """anchor() of the first and the last group of host reads in `groups`:
    an anchor's bare synchronizes follow one another with no other runtime
    call between them, so the first group is the first ANCHORS-long run of
    synchronizes in the trace and the last the last such run (its first
    ANCHORS: core/trace.py's own synchronize at the stop may join it)."""
    k = len(groups[0]) if groups else 0
    runs, run = [], []
    for ts, d, n in host:
        if n == SYNC:
            run.append((ts, d))
            continue
        if run:
            runs.append(run)
        run = []
    runs = [r for r in runs + [run] if len(r) >= k > 0]
    if not runs:
        return []
    out = [anchor(runs[0][:k], groups[0])]
    if len(groups) > 1 and len(runs) > 1:
        out.append(anchor(runs[-1][:k], groups[-1]))
    return out


def clock(pairs: list):
    """perf_counter_ns -> trace us, on the line through the first and last
    anchors (host ns, offset ns, ...) (an offset for one)."""
    (h0, o0), (h1, o1) = pairs[0][:2], pairs[-1][:2]
    drift = (o1 - o0) / (h1 - h0) if h1 != h0 else 0.0
    return lambda t: (t + o0 + (t - h0) * drift) / 1e3


def innermost(spans: list, to_us):
    """A function from a trace time (us) to the name of the innermost
    program span running then, or None."""
    keep = sorted((s.start, i) for i, s in enumerate(spans)
                  if s.end and s.name not in WAITS)
    starts, order = [to_us(t) for t, _ in keep], [i for _, i in keep]
    where = {i: (to_us(s.start), to_us(s.end))
             for i, s in enumerate(spans) if s.end}

    def name_at(t: float) -> str | None:
        k = bisect.bisect_right(starts, t) - 1
        j = order[k] if k >= 0 else None
        while j is not None:
            s, e = where.get(j, (t + 1, t))     # an open span covers none
            if s <= t <= e:
                return spans[j].name
            j = spans[j].parent
        return None
    return name_at


def split_idle(dev: list, host: list, spans: list, to_us,
               idle_gaps: list) -> list:
    """`idle_gaps` (core/trace.py's [[host op, seconds]]) with its
    "(python)" entry split by the innermost program span over each such
    gap's middle, most time first. Gaps are found as core/trace.py finds
    them."""
    merged = trace._union((ts, ts + d) for ts, d in dev)
    starts = [h[0] for h in host]
    name_at = innermost(spans, to_us)
    parts = collections.Counter()
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 5000), -1):
            ts, d, _ = host[j]
            if ts + d >= mid:
                break
        else:
            span = name_at(mid)
            parts[PYTHON if span is None else f"{PYTHON} {span}"] += \
                (s1 - e0) * 1e-6
    out = [g for g in idle_gaps if g[0] != PYTHON]
    if any(g[0] == PYTHON for g in idle_gaps):
        out += [[n, s] for n, s in parts.items()]
    return sorted(out, key=lambda g: -g[1])


def reads_held(host: list, spans: list, to_us,
               window: tuple[float, float]) -> tuple[int, int]:
    """(step.read spans inside the trace's `window` (us) that hold a host
    read's runtime call (READS) once mapped, step.read spans there)."""
    calls = sorted((ts, ts + d) for ts, d, n in host if n in READS)
    starts = [c[0] for c in calls]
    held = total = 0
    for s in spans:
        if s.name != "step.read" or not s.end:
            continue
        a, b = to_us(s.start), to_us(s.end)
        if not window[0] <= a <= b <= window[1]:
            continue
        total += 1
        k = bisect.bisect_left(starts, a)
        held += k < len(calls) and calls[k][1] <= b
    return held, total


class AnchoredTracer(trace.Tracer):
    """core/trace.py's Tracer with the clock anchors and the split of
    "(python)" (see the module docstring). After `finish`, `offsets_ms`
    and `reads` (reads_held) say how well the clocks agree; both go to
    stderr."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.anchor_reads: list[tuple[int, int]] = []
        self.offsets_ms: list[float] = []
        self.reads = (0, 0)

    def _anchor(self) -> None:
        if self.cuda:
            import torch
            reads = []
            for _ in range(ANCHORS):
                # the bare call: the reads then hold little but the event
                t0 = time.perf_counter_ns()
                torch._C._cuda_synchronize()
                reads.append((t0, time.perf_counter_ns()))
            self.anchor_reads.append(reads)

    def _hold(self, burst: int) -> bool:
        starting = self.prof is None and self._t1 is None
        held = super()._hold(burst)
        if starting and self.prof is not None:
            self._anchor()
        return held

    def stop(self, burst: int) -> None:
        if self.prof is not None and self._t1 is None:
            self._anchor()
        super().stop(burst)

    def finish(self):
        if self.prof is None:
            return None
        # the exported trace's intervals, kept while Tracer.finish reads
        # it as it always does
        kept = {}
        export = self.prof.export_chrome_trace

        def export_and_keep(path):
            export(path)
            with open(path) as f:
                kept["events"] = events_of(json.load(f)["traceEvents"])

        self.prof.export_chrome_trace = export_and_keep
        tr = super().finish()
        dev, host = kept.pop("events")
        pairs = anchors(host, self.anchor_reads)
        self.offsets_ms = [o / 1e6 for _, o, _ in pairs]
        rec = recorder()
        spans = rec.spans() if rec is not None else []
        if pairs and spans:
            to_us = clock(pairs)
            tr = dataclasses.replace(tr, idle_gaps=split_idle(
                dev, host, spans, to_us, tr.idle_gaps))
            times = [ts for ts, _ in dev] + [h[0] for h in host]
            self.reads = reads_held(host, spans, to_us,
                                    (min(times), max(times)))
        counts = window_counts(self.loop, spans)
        if counts is not None:
            lo, hi = self.loop.t0 * 1e9, self.loop.t_end * 1e9
            sizes = collections.Counter(
                len(s.rid) if isinstance(s.rid, tuple) else 1 for s in spans
                if s.name == "admit.group" and lo <= s.start <= hi)
            print(f"spans: the window admitted {counts['admitted']} requests "
                  f"in {counts['admit_groups']} groups (requests a group: "
                  f"{dict(sorted(sizes.items()))}); counters {counts}",
                  file=sys.stderr)
        apart = (pairs[-1][0] - pairs[0][0]) / 1e9 if pairs else 0.0
        print(f"spans: clock offsets of the two anchors {apart:.3f} s apart "
              f"{', '.join(f'{o:.6f}' for o in self.offsets_ms)} ms "
              f"(trace minus perf_counter; to within "
              f"{', '.join(f'{u / 1e3:.3f}' for _, _, u in pairs)} us); "
              f"step.read spans holding a "
              f"{' or '.join(READS)}: {self.reads[0]} of {self.reads[1]}",
              file=sys.stderr)
        return tr
