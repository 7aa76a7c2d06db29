"""Build the port's CUDA sources at first use and bind them with ctypes.

``csrc/*.cu`` are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, cached in
``haslr_tpu_torch/_build/`` (gitignored) under a hash of the sources and
flags, and loaded with :mod:`ctypes`.  Nothing here runs at import time:
the first kernel launch builds, so a CPU-only machine never needs
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

# (library, seconds the build took — 0.0 when it came from the cache,
# nvcc's stderr with the ptxas register/shared-memory report)
_state: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # reads, r_lens, drafts, d_lens, base, dirs, planes, stats,
    # B, R, D, W, match, mismatch, gap, stream
    "hx_rowscan_votes": [_P] * 8 + [_I] * 7 + [_P],
    # reads, r_lens, drafts, d_lens, base, dirs, runs, n_runs,
    # B, R, D, W, match, mismatch, gap, maxr, stream
    "hx_rowscan_cigar": [_P] * 8 + [_I] * 8 + [_P],
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


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    if "lib" in _state:
        return _state["lib"]
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    so = os.path.join(BUILD_DIR, f"libhaslr_cuda_{h.hexdigest()[:16]}.so")
    t0 = time.time()
    log = ""
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {res.returncode}):\n{res.stderr}"
            )
        os.replace(tmp, so)
        log = res.stderr
    cdll = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _state.update(lib=cdll, seconds=time.time() - t0, log=log)
    return cdll


def build_info() -> tuple[float, str]:
    """(build seconds, nvcc/ptxas stderr) of the loaded library."""
    lib()
    return _state["seconds"], _state["log"]
