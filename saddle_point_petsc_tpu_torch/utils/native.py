"""ctypes bindings for the port's native host kernels (csrc/native_host.cpp):
ILU(0) factorization, reverse Cuthill-McKee ordering, greedy aggregation,
COO -> CSR with duplicates summed, and exact CSR triangular solves.

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
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.sptpu_ilu0.restype = ctypes.c_int64
        lib.sptpu_ilu0.argtypes = [ctypes.c_int64, i32p, i32p, f64p]
        lib.sptpu_rcm.restype = None
        lib.sptpu_rcm.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
        lib.sptpu_aggregate.restype = ctypes.c_int64
        lib.sptpu_aggregate.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.sptpu_coo_to_csr.restype = ctypes.c_int64
        lib.sptpu_coo_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p, f64p, i32p, i32p, f64p, i64p]
        for name in ("sptpu_lower_solve_unit", "sptpu_upper_solve"):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [ctypes.c_int64, i32p, i32p, f64p, f64p, f64p]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def ilu0(indptr, indices, data, n):
    """ILU(0) of a CSR with sorted column indices: returns the factored f64
    values (L strictly lower with a unit diagonal implied, U upper with the
    diagonal, in the same pattern). indptr and indices may be int64; they
    go to the library as int32. Raises ZeroDivisionError on a zero pivot
    or a missing diagonal."""
    lib = _lib()
    if len(indptr) != n + 1 or indptr[-1] != len(indices) or len(data) != len(indices):
        raise ValueError(f"ilu0: a CSR of {n} rows needs {n + 1} row pointers and one value per index")
    if len(indices) >= 2**31:
        raise ValueError(f"ilu0: {len(indices)} entries overflow the library's int32 indices")
    data = np.array(data, dtype=np.float64, order="C")  # a copy, factored in place
    rc = lib.sptpu_ilu0(
        n,
        np.ascontiguousarray(indptr, np.int32),
        np.ascontiguousarray(indices, np.int32),
        data,
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILU(0): zero pivot at row {rc - 1}")
    return data


def coo_to_csr(rows, cols, vals, m):
    """COO triplets -> (indptr, cols, vals) of an m-row CSR: sorted by row,
    then column, duplicates summed; rows < 0 (padding) dropped."""
    lib = _lib()
    rows = np.ascontiguousarray(rows, np.int32)
    nnz = rows.shape[0]
    if len(cols) != nnz or len(vals) != nnz:
        raise ValueError(f"coo_to_csr: {nnz} rows, {len(cols)} columns and {len(vals)} values")
    indptr = np.zeros(m + 1, np.int32)
    out_cols = np.zeros(nnz, np.int32)
    out_vals = np.zeros(nnz, np.float64)
    out_nnz = np.zeros(1, np.int64)
    lib.sptpu_coo_to_csr(m, nnz, rows, np.ascontiguousarray(cols, np.int32),
                         np.ascontiguousarray(vals, np.float64), indptr, out_cols, out_vals, out_nnz)
    k = int(out_nnz[0])
    return indptr, out_cols[:k], out_vals[:k]


def _triangular(name, indptr, indices, data, b):
    n = b.shape[0]
    if len(indptr) != n + 1 or len(indices) != len(data) or len(indices) < indptr[-1]:
        raise ValueError(f"{name}: a CSR of {n} rows needs {n + 1} row pointers and one value per index")
    if len(indices) and not 0 <= np.min(indices) <= np.max(indices) < n:
        raise ValueError(f"{name}: column indices outside [0, {n})")
    x = np.zeros(n, np.float64)
    getattr(_lib(), name)(n, np.ascontiguousarray(indptr, np.int32),
                          np.ascontiguousarray(indices, np.int32), np.ascontiguousarray(data, np.float64),
                          np.ascontiguousarray(b, np.float64), x)
    return x


def lower_solve_unit(indptr, indices, data, b):
    """x with (I + L) x = b, L the strictly lower CSR (indptr, indices, data)."""
    return _triangular("sptpu_lower_solve_unit", indptr, indices, data, b)


def upper_solve(indptr, indices, data, b):
    """x with U x = b, U the upper CSR with its diagonal (entries left of the
    diagonal are skipped; a row without a diagonal divides by 1)."""
    return _triangular("sptpu_upper_solve", indptr, indices, data, b)


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
