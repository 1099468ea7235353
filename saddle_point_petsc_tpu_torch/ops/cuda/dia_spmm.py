"""Kernel B6, the DIA SpMM, behind a PyTorch entry point.

`dia_spmm(data, X, offsets)`: Y[i, c] = sum_d data[d, i] * X[i + offsets[d], c]
for row-indexed bands data (ndiag, n) and k dense columns X (n, k), with X
taken as 0 outside [0, n). It replaces the TPU kernel `_dia_spmm_kernel`
(saddle_point_petsc_tpu/ops/pallas/spmm.py). X may be any strided view,
among them the transpose of a contiguous (k, n) batch; Y takes X's layout
when X is dense (`torch.empty_like`), so the transpose of Y is then a
contiguous (k, n) batch again. On CPU tensors it runs the plain PyTorch
version `dia_spmm_plain`; on CUDA tensors it launches the CUDA kernel in
csrc/dia_spmm.cu, built at first use by `_build`, or raises. `launches`
counts the kernel launches; `reset_launches()` zeroes it.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.ops.cuda.dia import _INT32, _offsets_on

launches = 0  # kernel B6 launches since the last reset_launches()

_DTYPES = (torch.float32, torch.float64)
_lib = None


def reset_launches():
    global launches
    launches = 0


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


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("dia_spmm")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("dia_spmm_f32", "dia_spmm_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, i64, i64, i64, i64, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def _launch(data, X, offsets):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    global launches
    lib = _library()
    offs = _offsets_on(tuple(offsets), X.device)
    n, k = X.shape
    Y = torch.empty_like(X)
    fn = lib.dia_spmm_f32 if X.dtype == torch.float32 else lib.dia_spmm_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(data.data_ptr(), X.data_ptr(), Y.data_ptr(), offs.data_ptr(), len(offsets),
                n, k, *X.stride(), *Y.stride(), stream)
    _build.check(lib, "dia_spmm", rc)
    launches += 1
    return Y


def dia_spmm(data, X, offsets):
    """Y = A X for DIA bands data (ndiag, n), X (n, k) of any strides and
    static offsets; returns (n, k)."""
    offsets = tuple(offsets)
    _check(data, X, offsets)
    if X.device.type == "cpu":
        return dia_spmm_plain(data, X, offsets)
    return _launch(data, X, offsets)
