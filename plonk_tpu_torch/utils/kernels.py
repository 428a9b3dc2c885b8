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

import torch

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
_L = ctypes.c_longlong


class BigFieldArg(ctypes.Structure):
    """csrc/bigmont.cuh BigField, passed by value: the modulus and 2p as
    eight 32-bit limbs each, and -p^-1 mod 2^32."""
    _fields_ = [("p", ctypes.c_uint32 * 8), ("p2", ctypes.c_uint32 * 8),
                ("np", ctypes.c_uint32)]


class U256Arg(ctypes.Structure):
    """csrc/bigmont.cuh U256: a 256-bit value as eight 32-bit limbs."""
    _fields_ = [("v", ctypes.c_uint32 * 8)]


def _limbs32(v: int):
    return (ctypes.c_uint32 * 8)(*[(v >> (32 * k)) & 0xFFFFFFFF
                                   for k in range(8)])


def big_field_arg(p: int) -> BigFieldArg:
    return BigFieldArg(_limbs32(p), _limbs32(2 * p),
                       (-pow(p, -1, 1 << 32)) % (1 << 32))


def u256_arg(v: int) -> U256Arg:
    return U256Arg(_limbs32(v))


# C signature of every entry point: name -> argtypes (all return int, the
# cudaError_t of the launch)
_SIGNATURES = {
    # y, compact uint32 twiddles, out, R, S, dif, p, n_prime, stream
    "row_stages_launch": [_P, _P, _P, _L, _I, _I, _U, _U, _P],
    # y, tw1, twm, tw2 (uint32 tables), out, nb, n1, n2, mirror, scale,
    # scaled, p, n_prime, passes (a mask: 1 first pass, 2 grid barrier,
    # 4 second pass), stream
    "onepass_ntt_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _U,
                           _U, _I, _P],
    # x, w_limbs, tw, out, R, C, K, L, limb bits, T, p, n_prime, stream
    "mont_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U,
                           _P],
    # scalars, packed table, its strides (3), B, W, wb, L, p, n_prime,
    # one, c2, c3, c8, partials, n_tiles, ticket, out, stream
    "commit_many_launch": [_P, _P, _L, _L, _L, _I, _I, _I, _I, _U, _U, _U,
                           _U, _U, _U, _P, _I, _P, _P, _P],
    # y, packed twiddle powers, out, R, C, S, dif, field, scale, scaled,
    # stream
    "big_row_launch": [_P, _P, _P, _I, _I, _I, _I, BigFieldArg, U256Arg, _I,
                       _P],
    # scalar words, base infinity flags, Ls, NW, wb, packed table, B, W, nb,
    # L, field, one, partials, n_tiles, ppt, out, stream
    "big_commit_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                          BigFieldArg, U256Arg, _P, _I, _I, _P, _P],
    # srcs[D], dsts[D] (arrays of pointers), D, chunk bytes, unit, stream
    "all_gather_launch": [_P, _P, _I, _L, _I, _P],
    # srcs[D], dsts[D], D, nb, nr, then in units run, sb, sr, db, dr,
    # src_pair, dst_pair; unit, stream
    "all_to_all_launch": [_P, _P, _I] + [_L] * 9 + [_I, _P],
    # srcs[D], dsts[D], totals (D, D), state, D, m, shifted, p, n_prime,
    # one, stream
    "prefix_scan_launch": [_P, _P, _P, _P, _I, _L, _I, _U, _U, _U, _P],
}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card. There is no fallback: without CUDA the default raises, and
    a caller passes device="cpu" to run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible to torch; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


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
    """Compile every csrc/*.cu into the shared library: one nvcc per
    source, all started together, then one link. Returns the compilers'
    output (the ptxas register and shared-memory report)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = os.getpid()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}.tmp"
        res = subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", tmp]
                             + objs, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(logs)


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
