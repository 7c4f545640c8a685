"""One run of one cell, as run.py's, with the program's spans on the device
trace's clock:

    python3 cudabench/span_run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> [--spans 1]

With --trace 1 the traced sub-window is profiled by core/spantrace.py's
AnchoredTracer in place of core/trace.py's Tracer: the result line's
`breakdown.idle_gaps` has its "(python)" entry split by the program's
spans, and stderr gives the two clock anchors' offsets and how many of
the sub-window's `step.read` spans hold a host read's runtime call. With
--spans 1 the program records its spans in an untraced run too, which
measures what they cost the end-to-end metrics. The last line of stdout
is run.py's.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(ROOT))
    from cudabench.run import _process_start

    T_START = _process_start()
    import os

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    argv = sys.argv[1:]
    spans = "--spans" in argv
    if spans:
        i = argv.index("--spans")
        spans = argv[i + 1:i + 2] == ["1"]
        del argv[i:i + 2]
    from cudabench.core import spantrace, trace
    from cudabench.core.bench import main

    trace.Tracer = spantrace.AnchoredTracer
    rec = spantrace.recorder()
    if spans and rec is not None:
        rec.start()
    sys.exit(main(argv, t_start=T_START, root=ROOT))
