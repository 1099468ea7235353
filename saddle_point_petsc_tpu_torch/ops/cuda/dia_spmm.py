"""Kernel B6, the DIA SpMM, behind a PyTorch entry point.

`dia_spmm(data, X, offsets)`: Y[i, c] = sum_d data[d, i] * X[i + offsets[d], c]
for row-indexed bands data (ndiag, n) and k dense columns X (n, k), with X
taken as 0 outside [0, n). It replaces the TPU kernel `_dia_spmm_kernel`
(saddle_point_petsc_tpu/ops/pallas/spmm.py). X may be any strided view,
among them the transpose of a contiguous (k, n) batch; Y takes X's layout
when X is dense (`torch.empty_like`), so the transpose of Y is then a
contiguous (k, n) batch again. On CPU tensors it runs the plain PyTorch
version `dia_spmm_plain`; on CUDA tensors it launches the CUDA kernel in
csrc/dia_spmm.cu, built at first use by `_build`, or raises.

The kernel has three paths that sum alike (the source's note says how each
moves its bytes); `_path` picks one per call, by what measured fastest on
an H100 at the 1025^2-node operator (PERF.md): the blocked path for f32 X
and Y whose columns are contiguous (the (k, n) batch) when the offsets
form at most MAX_RUNS runs of consecutive offsets (`plan_runs`; the plan
of an offsets tuple is built once and cached), the 16-byte row path for X
and Y that are row-major with rows of whole, aligned 8-column chunks, the
strided path for everything else (in f64 the blocked path measured no
faster than the strided one on the (k, n) batch). Each launch adds 1 to
`B6.launches` in `utils.monitor.counters`.
"""
from __future__ import annotations

import ctypes

import torch

from saddle_point_petsc_tpu_torch.ops.cuda.dia import _INT32, _offsets_on
from saddle_point_petsc_tpu_torch.utils import monitor


# the blocked path's limits (csrc/dia_spmm.cu, checked against the library's
# dia_spmm_limits when it loads): the most bands in a run, the most runs in
# a plan
MAX_BANDS, MAX_RUNS = 8, 16
PATHS = ("strided", "rows", "blocked")  # the kernel's path numbers 0, 1, 2

_DTYPES = (torch.float32, torch.float64)
_lib = None
_plans = {}  # (offsets, n) -> _Plan, or None where the plan is longer than MAX_RUNS


def dia_spmm_plain(data, X, offsets):
    """The plain version: shifted row slices of X, bands in offset order,
    as the XLA chain of the JAX package's `dia_matmat` (ops/sparse.py)
    sums them. Elementwise, so column c has the bits of
    dia_spmv_plain(data, X[:, c], offsets)."""
    n = X.shape[0]
    Y = torch.zeros_like(X)
    for k, off in enumerate(offsets):
        if abs(off) >= n:
            continue
        if off == 0:
            Y = Y + data[k][:, None] * X
        elif off > 0:
            Y[: n - off] += data[k, : n - off, None] * X[off:]  # in place: Y is ours
        else:
            Y[-off:] += data[k, -off:, None] * X[: n + off]
    return Y


def plan_runs(offsets, n, max_bands=MAX_BANDS):
    """Split the bands that meet a row (|offset| < n), in the order given,
    into runs of consecutive bands whose offsets rise by one (lo, lo + 1,
    ...), at most `max_bands` a run; returns a tuple of runs, each a tuple
    of (band index, offset). The blocked path loads the values of X a run
    meets once and applies the runs in order, so the sum keeps the
    offsets' order."""
    runs, cur = [], []
    for d, off in enumerate(offsets):
        if abs(off) >= n:
            continue
        if cur and len(cur) < max_bands and off == cur[-1][1] + 1:
            cur.append((d, off))
        else:
            if cur:
                runs.append(tuple(cur))
            cur = [(d, off)]
    if cur:
        runs.append(tuple(cur))
    return tuple(runs)


class _Plan(ctypes.Structure):
    """The kernel's `Plan`: per run (lowest offset, first band, band count),
    per band its row of data."""

    _fields_ = [
        ("nruns", ctypes.c_int),
        ("run", (ctypes.c_int * 3) * MAX_RUNS),
        ("band", ctypes.c_int * (MAX_RUNS * MAX_BANDS)),
    ]


def _plan(offsets, n):
    """The blocked path's _Plan of (offsets, n), cached; None when the
    offsets make no run or more than MAX_RUNS runs."""
    key = (offsets, n)
    if key not in _plans:
        runs = plan_runs(offsets, n)
        plan = None
        if 1 <= len(runs) <= MAX_RUNS:
            plan = _Plan(nruns=len(runs))
            first = 0
            for r, run in enumerate(runs):
                plan.run[r][:] = (run[0][1], first, len(run))
                for d, _ in run:
                    plan.band[first] = d
                    first += 1
        _plans[key] = plan
    return _plans[key]


def _rows_aligned(X, Y):
    """The row path's condition: row-major X and Y, rows of whole 8-column
    chunks, 16-byte-aligned."""
    es = X.element_size()
    return all(
        T.stride(1) == 1 and T.shape[1] % 8 == 0 and T.stride(0) * es % 16 == 0
        and T.data_ptr() % 16 == 0 for T in (X, Y)
    )


def _path(X, Y, plan):
    """The path for this call (see the module's note)."""
    if X.dtype == torch.float32 and plan is not None and X.stride(0) == 1 and Y.stride(0) == 1:
        return "blocked"
    if _rows_aligned(X, Y):
        return "rows"
    return "strided"


def _check(data, X, offsets):
    """Validate device, dtype, contiguity, shapes and offsets; raise otherwise."""
    if not isinstance(data, torch.Tensor) or not isinstance(X, torch.Tensor):
        raise TypeError("dia_spmm takes torch tensors")
    if data.device != X.device:
        raise ValueError(f"data on {data.device}, X on {X.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype not in _DTYPES or X.dtype != data.dtype:
        raise TypeError(
            f"data {data.dtype} and X {X.dtype}: need one of float32, float64 for both"
        )
    if X.ndim != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X shape {tuple(X.shape)}, need (n, k) with n, k >= 1")
    if tuple(data.shape) != (len(offsets), X.shape[0]):
        raise ValueError(
            f"data shape {tuple(data.shape)}, need (len(offsets), n) = "
            f"({len(offsets)}, {X.shape[0]})"
        )
    if not all(isinstance(o, int) and _INT32[0] <= o <= _INT32[1] for o in offsets):
        raise ValueError("offsets must be a tuple of 32-bit Python ints")
    if not data.is_contiguous():
        raise ValueError("dia_spmm needs contiguous data")


def _bind(lib):
    """Set the argument types of a loaded B6 library (csrc/dia_spmm.cu, or a
    variant of it built from the same interface) and check its limits."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("dia_spmm_f32", "dia_spmm_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [i32, ptr, ptr, ptr, ptr, i32, ctypes.POINTER(_Plan), i64, i32,
                       i64, i64, i64, i64, ptr]
        fn.restype = i32
    lib.dia_spmm_error_string.argtypes = [i32]
    lib.dia_spmm_error_string.restype = ctypes.c_char_p
    limits = [ctypes.c_int() for _ in range(2)]
    lib.dia_spmm_limits(*(ctypes.byref(v) for v in limits))
    if tuple(v.value for v in limits) != (MAX_BANDS, MAX_RUNS):
        raise RuntimeError(f"dia_spmm limits {[v.value for v in limits]} != the planner's")
    return lib


def _library():
    global _lib
    if _lib is None:
        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        _lib = _bind(_build.load_library("dia_spmm"))
    return _lib


def _launch(data, X, offsets, path=None, lib=None):
    """Launch one path of the kernel (None: `_path`'s choice) from `lib`
    (None: the library built from csrc/dia_spmm.cu); returns Y."""
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = lib or _library()
    n, k = X.shape
    plan = _plan(offsets, n)
    Y = torch.empty_like(X)
    path = path or _path(X, Y, plan)
    if path == "blocked" and plan is None:
        raise ValueError(f"offsets {offsets} make no plan of 1 to {MAX_RUNS} runs at n = {n}")
    offs = _offsets_on(offsets, X.device) if path != "blocked" else None
    fn = lib.dia_spmm_f32 if X.dtype == torch.float32 else lib.dia_spmm_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(PATHS.index(path), data.data_ptr(), X.data_ptr(), Y.data_ptr(),
                offs.data_ptr() if offs is not None else None, len(offsets),
                ctypes.byref(plan) if plan is not None else None, n, k,
                *X.stride(), *Y.stride(), stream)
    _build.check(lib, "dia_spmm", rc)
    monitor.count("B6.launches")
    return Y


def dia_spmm(data, X, offsets):
    """Y = A X for DIA bands data (ndiag, n), X (n, k) of any strides and
    static offsets; returns (n, k)."""
    offsets = tuple(offsets)
    _check(data, X, offsets)
    if X.device.type == "cpu":
        return dia_spmm_plain(data, X, offsets)
    return _launch(data, X, offsets)
