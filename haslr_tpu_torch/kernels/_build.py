"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface; the
compilers start together and run in parallel.  Each library is cached in
``haslr_tpu_torch/_build/`` (gitignored) under a hash of its source and
the flags, and loaded with :mod:`ctypes`.  Nothing here runs at import
time: the first kernel launch builds, so a CPU-only machine never needs
``nvcc``.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (entry points by name, seconds the build took — 0.0 when every library
# came from the cache, nvcc's stderr with the ptxas register/shared-memory
# report, kept beside each library so that a cached one still has it)
_state: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# The NW entry points take reads, r_lens, drafts, d_lens, base, dirs
# (scratch or output), then each entry point's outputs, B, R, D, W,
# match, mismatch, gap, its own ints, stream.  The row-scan entry points
# end their ints with the route: C, wpr, reads_per_block; the wavefront
# ones take the code rows' widths for R and D and end with the band's R
# and D and the route.
_SIGNATURES = {
    # + planes, stats; + route
    "hx_rowscan_votes": [_P] * 8 + [_I] * 10 + [_P],
    # + runs, n_runs; + maxr, route
    "hx_rowscan_cigar": [_P] * 8 + [_I] * 11 + [_P],
    # + mapping; + route
    "hx_rowscan_mapping": [_P] * 7 + [_I] * 10 + [_P],
    "hx_wavefront_dirs": [_P] * 6 + [_I] * 12 + [_P],
    # + mapping
    "hx_wavefront_mapping": [_P] * 7 + [_I] * 12 + [_P],
    # + planes, stats
    "hx_wavefront_votes": [_P] * 8 + [_I] * 12 + [_P],
    # planes, ok, stats, win_ptr, counts, cov, ins1, ins2, n_reads; N, S,
    # row stride, the insertion planes' offsets; stream
    "hx_vote_tables": [_P] * 9 + [_I] * 5 + [_P],
    # N, S; out (7 int32)
    "hx_vote_tables_plan": [_I] * 2 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from haslr_tpu_torch/csrc at first use"
        )
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _target(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(os.path.basename(src).encode() + f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR,
                        f"libhaslr_{stem}_{h.hexdigest()[:16]}.so")


def lib() -> dict:
    """The kernels' C entry points by name, every source built on the
    first call."""
    if "lib" in _state:
        return _state["lib"]
    t0 = time.time()
    targets = [_target(src) for src in _sources()]
    todo = [(src, so) for src, so in zip(_sources(), targets)
            if not os.path.isfile(so)]
    nvcc = _nvcc() if todo else ""
    jobs = []
    for src, so in todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((src, so, tmp, proc))
    logs, failed = [], []
    for src, so, tmp, proc in jobs:  # wait for all before raising
        _out, err = proc.communicate()
        if proc.returncode == 0:
            with open(f"{tmp}.log", "w") as f:
                f.write(err)
            os.replace(f"{tmp}.log", f"{so}.log")
            os.replace(tmp, so)
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"nvcc failed on {os.path.basename(src)} "
                          f"(exit {proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    fns = {}
    for so in targets:
        if os.path.isfile(f"{so}.log"):  # also for a library built before
            with open(f"{so}.log") as f:
                logs.append(f.read())
        cdll = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
    missing = sorted(set(_SIGNATURES) - set(fns))
    if missing:
        raise RuntimeError(f"kernel entry points not built: {missing}")
    _state.update(lib=fns, seconds=time.time() - t0, log="".join(logs))
    return fns


def build_info() -> tuple[float, str]:
    """(build seconds, nvcc/ptxas stderr) of the loaded libraries."""
    lib()
    return _state["seconds"], _state["log"]
