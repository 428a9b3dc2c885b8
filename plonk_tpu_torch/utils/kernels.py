"""Build, load and count the package's CUDA kernels.

The sources in `plonk_tpu_torch/csrc/*.cu` are compiled on first use with
`nvcc` into one shared library with a plain C interface, which is loaded
with ctypes (the same lazy-build pattern as `plonk_tpu/utils/native.py`).
No PyTorch header is compiled, so the build takes seconds. The library
lands in `build/plonk_tpu_torch/` at the root of the checkout and is
rebuilt when a source is newer than it.

Each kernel wrapper calls `count(name)` once per launch of its kernel,
so a run can show that the main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "plonk_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libplonk_tpu_torch.so")
ARCH = "arch=compute_90a,code=sm_90a"

LAUNCHES: collections.Counter = collections.Counter()

_lib = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint

# C signature of every entry point: name -> argtypes (all return int, the
# cudaError_t of the launch)
_SIGNATURES = {
    # y, tw, out, R, C, S, p, n_prime, stream
    "row_stages_launch": [_P, _P, _P, _I, _I, _I, _U, _U, _P],
    # scalars, tx, ty, tinf, B, W, nb, L, wb, p, n_prime, one, c2, c3,
    # c8, partials, n_tiles, points_per_thread, out, stream
    "commit_many_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _U,
                           _U, _U, _U, _P, _I, _I, _P, _P],
}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    LAUNCHES.clear()


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(f) > built for f in deps)


def build() -> str:
    """Compile every csrc/*.cu into the shared library; returns the
    compiler's output (ptxas register and shared-memory report)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp] + _sources()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t, else count it."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    count(name)
