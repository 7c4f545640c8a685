"""Build and load the port's CUDA kernels.

Every `*.cu` under `qwen3_tpu_torch/csrc/` compiles with nvcc (one process
per source, all started together) into an object, and the objects link into
one shared library with a plain C interface,
`build/qwen3_tpu_torch/libqwen3_kernels.so` under the repository root. It is
loaded with ctypes. The build runs at first use and again whenever a source
is newer than the library, under an exclusive lock on
`build/qwen3_tpu_torch/build.lock` (a flock, released when its process
ends), so that ranks started together build it once; it never includes
PyTorch's headers, so it takes seconds. nvcc is `$CUDA_HOME/bin/nvcc`
(default `/usr/local/cuda`) or the first `nvcc` on PATH.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "qwen3_tpu_torch"
LIB = BUILD_DIR / "libqwen3_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# -fmad=false: no a*b+c contraction, so fp32 sums round as written. The fused
# matmul keeps nvcc's default, PyTorch's own build setting, for the expf of
# its sigmoid; the kernels it shares with q8_matmul.cu (q8_kernels.cuh) spell
# every product and sum with an intrinsic, so both builds round alike
NO_CONTRACT_EXCEPT = {"q8_fused.cu"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures: pointers and the stream as c_void_p, every int as c_int
# (a long long as c_longlong), every float as c_float
SIGNATURES = {
    "q8q8_matmul": [_P] * 6 + [_I] * 7 + [_P],
    "q8q8_matmul_stacked": [_P] * 4 + [_I, _P, _P] + [_I] * 7 + [_P],
    "q8_fast_matmul": [_P] * 4 + [_I] * 5 + [_P],
    "q8_fast_matmul_stacked": [_P] * 3 + [_I, _P] + [_I] * 5 + [_P],
    "q8i8_matmul": [_P] * 6 + [_I] * 5 + [_P],
    "q8i8_matmul_stacked": [_P] * 5 + [_I, _P] + [_I] * 5 + [_P],
    "q8_fused_matmul": [_P] * 9 + [_I] * 9 + [_P],
    "flash_decode": [_P] * 10 + [_I] * 8 + [_F, _P],
    "flash_decode_two_segment": [_P] * 15 + [_I] * 9 + [_F, _P],
    "flash_prefill": [_P] * 9 + [_I] * 10 + [_F, _P],
    "batched_decode_partial": [_P] * 12 + [_I] * 9 + [_F, _P],
    "kv_write_rows": [_P] * 3 + [_I] * 6 + [_P],
    "q8q8_untiled": [_P] * 6 + [_I] * 8 + [_P],
    "q8_untiled": [_P] * 6 + [_I] * 10 + [_P],
    "rmsnorm": [_P] * 4 + [_I] * 3 + [_L] * 2 + [_I] * 2 + [_F, _P],
    "add_rmsnorm": [_P] * 6 + [_I] * 4 + [_F, _P],
    "qk_norm_rope": [_P] * 8 + [_I, _I, _L, _L, _I] * 2 + [_I, _L, _L]
                    + [_I] * 3 + [_F, _P],
    "softmax_sum": [_P] * 4 + [_I] * 3 + [_P],
    "prefix_sum": [_P] * 3 + [_I] * 3 + [_P],
    "pure_read_stacked": [_P, _I, _P] + [_I] * 5 + [_P],
    "pure_read_manual": [_P, _I, _P] + [_I] * 6 + [_P],
}

_lib = None
last_build_log = ""


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def stale() -> bool:
    if not LIB.exists():
        return True
    built = LIB.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def build(verbose: bool = False) -> float:
    """Compile every source in parallel and link the library; returns the
    wall seconds. `verbose` adds -Xptxas -v (registers, shared memory and
    spills per kernel) to the log kept in `last_build_log`."""
    global last_build_log
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        fmad = [] if src.name in NO_CONTRACT_EXCEPT else ["-fmad=false"]
        cmd = [nvcc, *ARCH, *FLAGS, *fmad, *extra, "-c", str(src), "-o",
               str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out.decode(errors='replace')}")
        if proc.returncode != 0:
            failed.append(src.name)
    last_build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{last_build_log}")
    tmp = BUILD_DIR / f"libqwen3_kernels.{tag}.so"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *(str(obj) for _s, obj, _p in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for _s, obj, _p in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - t0


def ensure_built() -> None:
    """Build the library if it is missing or stale, holding the build lock:
    a process that waited for another's build finds it fresh."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if stale():
            build()


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale."""
    global _lib
    if _lib is None:
        ensure_built()
        lib = ctypes.CDLL(str(LIB))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
