"""What the readers of the program's spans and counters share: the
recorder turned on for a traced run, and the spans and counters of the
measured window.

The program records its spans (qwen3_tpu_torch/utils/profiling.py::SPANS)
only once asked. Each such reader asks when it is loaded, in a run whose
command line says `--trace 1` (run.py's), so that the window of a traced
run is recorded and an untraced run's is not: the harness, which would be
the place to ask (core/bench.py's serve), does not yet. Where the program
has no recorder (an older checkout) or recorded nothing, every function
here gives None and the readers return None.

Times: the spans' ends are perf_counter_ns, the window's perf_counter
seconds (core/loop.py), one clock. Counters: core/spantrace.py's
window_counts.
"""

from __future__ import annotations

import sys

from cudabench.core import spantrace
from cudabench.core.spantrace import recorder


def traced(argv: list[str]) -> bool:
    """Whether a command line asks for a traced run (`--trace 1`)."""
    for i, a in enumerate(argv):
        if a == "--trace":
            return argv[i + 1:i + 2] == ["1"]
        if a.startswith("--trace="):
            return a == "--trace=1"
    return False


def record_if_traced(argv: list[str] | None = None) -> None:
    """Start the program's recorder if the run is traced and it is off."""
    rec = recorder()
    if rec is not None and not rec.on and traced(
            sys.argv if argv is None else argv):
        rec.start()


def spans():
    """The program's spans so far, or None."""
    rec = recorder()
    out = rec.spans() if rec is not None else None
    return out or None


def window_ns(run) -> tuple[float, float] | None:
    """The measured window on the spans' clock."""
    loop = run.loop
    if loop.b_end is None or loop.t_end <= loop.t0:
        return None
    return loop.t0 * 1e9, loop.t_end * 1e9


def window_counts(run) -> dict | None:
    """The engine's counters over the measured window, or None."""
    sp = spans()
    return None if sp is None else spantrace.window_counts(run.loop, sp)
