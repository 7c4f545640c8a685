"""Closed-loop clients on the port's serving engine.

Each of the mix's clients keeps one request in flight and sends its next
the moment its last completes, as serve.py's batch jobs do with a fixed
worker pool. Only the engine's public API is used: `submit`, `run`,
`Request.stream_cb`, `Request.finished`, `Request.out_ids` and
`Request.prompt_ids`.

The engine hands a slot's tokens to its client once a decode chunk, all
slots one after another: a *burst* of deliveries. A burst is named by the
program's count of decode steps at the time (the model module's
`counters()["decode_forward"]`), which does not change inside a burst.
The first burst ends set-up (the first wave prefilled, one chunk decoded)
and opens the window; the window closes at the first burst that comes
`seconds` after it. Tokens are counted by burst, so the window holds whole
chunks. After the close the loop serves on until the closing burst is
complete, every request submitted in the window has its first token and
every hold (a traced sub-window) is released, at most `grace` seconds,
then stops the engine from inside a callback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from cudabench.core.traffic import RequestStream, Spec


class Stop(Exception):
    """Raised from a stream callback to leave BatchedEngine.run."""


@dataclasses.dataclass
class Record:
    spec: Spec
    client: int
    req: object
    submit_t: float
    deliveries: list = dataclasses.field(default_factory=list)
    seen: int = 0                  # tokens delivered so far

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt_ids)


class ClosedLoop:
    def __init__(self, engine, stream: RequestStream, clients: int,
                 steps: Callable[[], int], request_type,
                 clock: Callable[[], float] = time.perf_counter):
        self.eng, self.stream, self.clients = engine, stream, clients
        self.steps, self.Request, self.clock = steps, request_type, clock
        self.records: list[Record] = []
        self.inflight: dict[int, Record] = {}
        self.bursts: dict[int, float] = {}   # burst -> first delivery time
        self.on_burst: list[Callable[[int, float], None]] = []
        # called with the burst once the window is served; each returns
        # True while it needs the loop to serve on
        self.holds: list[Callable[[int], bool]] = []
        self.b0 = self.t0 = self.b_end = self.t_end = None
        self.deadline = None
        self.grace = 60.0
        self.seconds = 0.0
        self.stopped_early = False

    # -- clients -----------------------------------------------------------

    def submit(self, client: int) -> None:
        spec = self.stream[len(self.records)]
        req = self.Request(prompt=spec.prompt, seed=spec.seed,
                           max_tokens=spec.max_tokens,
                           temperature=spec.temperature, top_p=spec.top_p)
        rec = Record(spec=spec, client=client, req=req,
                     submit_t=self.clock())
        req.stream_cb = lambda _data, rec=rec: self._deliver(rec)
        self.records.append(rec)
        self.inflight[client] = rec
        self.eng.submit(req)

    def _complete(self, rec: Record) -> None:
        del self.inflight[rec.client]
        self.submit(rec.client)

    def _deliver(self, rec: Record) -> None:
        t = self.clock()
        burst = self.steps()
        n = len(rec.req.out_ids) - rec.seen
        rec.seen += n
        rec.deliveries.append((t, n, burst))
        if burst not in self.bursts:
            self.bursts[burst] = t
            if self.b0 is None:
                self.b0, self.t0 = burst, t
                self.deadline = t + self.seconds
            elif self.b_end is None and t >= self.deadline:
                self.b_end, self.t_end = burst, t
            for hook in self.on_burst:
                hook(burst, t)
        if rec.client in self.inflight and (
                rec.seen >= rec.spec.max_tokens):
            self._complete(rec)
        for other in list(self.inflight.values()):
            if other.req.finished:
                self._complete(other)
        self._maybe_stop(burst, t)

    # -- the window ----------------------------------------------------------

    def in_window(self, rec: Record) -> bool:
        """Whether rec was submitted inside the window."""
        return self.t0 <= rec.submit_t <= self.t_end

    def _maybe_stop(self, burst: int, t: float) -> None:
        if self.b_end is None:
            return
        if t > self.t_end + self.grace:
            self.stopped_early = True
            raise Stop
        if burst == self.b_end and any(
                r.req.prompt_ids and not r.req.finished
                and r.seen < r.spec.max_tokens
                and (not r.deliveries or r.deliveries[-1][2] != burst)
                for r in self.inflight.values()):
            return      # the closing chunk's deliveries are not all in
        if not all(r.deliveries or r.req.finished
                   for r in self.records if self.in_window(r)):
            return
        if any([hold(burst) for hold in self.holds]):
            return
        raise Stop

    def run(self, seconds: float) -> None:
        """Send the first wave, then serve until the window has closed."""
        self.seconds = seconds
        for c in range(self.clients):
            self.submit(c)
        while True:
            try:
                self.eng.run()
            except Stop:
                return
            # the engine ran dry: every client's request finished, the last
            # of them without a delivery after it; send their next ones
            if self.t_end is not None and \
                    self.clock() > self.t_end + self.grace:
                self.stopped_early = True
                return
            for rec in list(self.inflight.values()):
                if rec.req.finished:
                    self._complete(rec)
