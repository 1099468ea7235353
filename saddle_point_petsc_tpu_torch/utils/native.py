"""ctypes bindings for the port's native host kernels (csrc/native_host.cpp):
reverse Cuthill-McKee ordering and greedy aggregation.

The library is built with g++ at first use into `csrc/_build/` (ignored by
git), named by a hash of the source and the flags, under a file lock
(`csrc.compile_once`), and loaded with ctypes. Nothing is built
or loaded when this module is imported. Every caller keeps a numpy or scipy
fallback for when the library does not load (`NativeUnavailable`).
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil

import numpy as np

from saddle_point_petsc_tpu_torch.csrc import BUILD_DIR, CSRC, compile_once

SOURCE = CSRC / "native_host.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def _library_path():
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnative_host_{digest}.so"


def _lib():
    global _LIB
    if _LIB is None:
        out = _library_path()
        try:
            if not out.exists():
                cxx = shutil.which("g++") or shutil.which("c++")
                if cxx is None:
                    raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
                compile_once(
                    "native_host", out, lambda tmp: (cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE))
                )
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError) as e:
            raise NativeUnavailable(f"native host library unavailable: {e}") from e
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.sptpu_rcm.restype = None
        lib.sptpu_rcm.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
        lib.sptpu_aggregate.restype = ctypes.c_int64
        lib.sptpu_aggregate.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def aggregate(indptr, indices, n):
    """Greedy standard aggregation on a strength graph -> (agg ids, count)."""
    lib = _lib()
    agg = np.zeros(n, np.int32)
    na = lib.sptpu_aggregate(
        n,
        np.ascontiguousarray(indptr, np.int32),
        np.ascontiguousarray(indices, np.int32),
        agg,
    )
    return agg, int(na)


def rcm(indptr, indices, n):
    """Reverse Cuthill-McKee permutation."""
    lib = _lib()
    perm = np.zeros(n, np.int32)
    lib.sptpu_rcm(
        n,
        np.ascontiguousarray(indptr, np.int32),
        np.ascontiguousarray(indices, np.int32),
        perm,
    )
    return perm
