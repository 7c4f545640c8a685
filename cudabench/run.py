"""The benchmark of qwen3_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 cudabench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA cards. The
last line of stdout is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), `device` and, last, `checks` (each number compared with its limit,
also the last lines of stderr). Without the cards, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.
"""

import sys
import time

_T_CALL = time.perf_counter()


def _process_start() -> float:
    """The process's start on the perf_counter clock (the kernel's record
    of it where /proc has one, else this module's first line)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return _T_CALL - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T_CALL


if __name__ == "__main__":
    import os
    from pathlib import Path

    T_START = _process_start()
    # one process with few threads: the host's CPU pools (OpenMP, BLAS)
    # would only spin beside the thread that launches the kernels
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    ROOT = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(ROOT))
    from cudabench.core.bench import main

    sys.exit(main(sys.argv[1:], t_start=T_START, root=ROOT))
