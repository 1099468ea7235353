"""Kernels B3 and B3', the DIA SpMV, behind two PyTorch entry points.

- `dia_spmv_2d(data, x, offsets)`: twin of `dia_spmv_pallas_2d`, the
  TPU kernel `_dia2d_kernel`; DIA operators and gamg levels call it.
- `dia_spmv(data, x, offsets)`: twin of `dia_spmv_pallas`, the 1D TPU
  kernel `_dia_kernel` that computes the same thing.

Both compute y[i] = sum_k data[k, i] * x[i + offsets[k]] for row-indexed
bands data (ndiag, n) and x (n,), with x taken as 0 outside [0, n), and
both launch the one kernel of csrc/dia_spmv.cu (TPU kernels in
saddle_point_petsc_tpu/ops/pallas/spmv.py). On CPU tensors they run the
plain PyTorch version `dia_spmv_plain`; on CUDA tensors they launch the
kernel, built at first use by `_build`, or raise. Each launch, through
either entry, adds 1 to `B3.launches` in `utils.monitor.counters`.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.utils import monitor


_DTYPES = (torch.float32, torch.float64)
_INT32 = (-(2**31), 2**31 - 1)
_lib = None
_tables = {}  # (offsets, device) -> int32 offsets on that device


def dia_spmv_plain(data, x, offsets):
    """The plain version: shifted multiply-adds in offset order, as the XLA
    chain of the JAX package's `dia_matvec` (ops/sparse.py) sums them."""
    n = x.shape[0]
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        if abs(off) >= n:
            continue
        if off == 0:
            y = y + data[k] * x
        elif off > 0:
            y[: n - off] += data[k, : n - off] * x[off:]  # in place: y is ours
        else:
            y[-off:] += data[k, -off:] * x[: n + off]
    return y


def _check(data, x, offsets):
    """Validate device, dtype, contiguity, shapes and offsets; raise otherwise."""
    if not isinstance(data, torch.Tensor) or not isinstance(x, torch.Tensor):
        raise TypeError("dia_spmv takes torch tensors")
    if data.device != x.device:
        raise ValueError(f"data on {data.device}, x on {x.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype not in _DTYPES or x.dtype != data.dtype:
        raise TypeError(
            f"data {data.dtype} and x {x.dtype}: need one of float32, float64 for both"
        )
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError(f"x shape {tuple(x.shape)}, need (n,) with n >= 1")
    if tuple(data.shape) != (len(offsets), x.shape[0]):
        raise ValueError(
            f"data shape {tuple(data.shape)}, need (len(offsets), n) = "
            f"({len(offsets)}, {x.shape[0]})"
        )
    if not all(isinstance(o, int) and _INT32[0] <= o <= _INT32[1] for o in offsets):
        raise ValueError("offsets must be a tuple of 32-bit Python ints")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv needs contiguous data and x")


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("dia_spmv")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("dia_spmv_f32", "dia_spmv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def _offsets_on(offsets, device):
    key = (offsets, device)
    if key not in _tables:
        _tables[key] = torch.tensor(offsets, dtype=torch.int32, device=device)
    return _tables[key]


def _launch(data, x, offsets):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = _library()
    offs = _offsets_on(tuple(offsets), x.device)
    y = torch.empty_like(x)
    fn = lib.dia_spmv_f32 if x.dtype == torch.float32 else lib.dia_spmv_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), offs.data_ptr(),
                len(offsets), x.shape[0], stream)
    _build.check(lib, "dia_spmv", rc)
    monitor.count("B3.launches")
    return y


def dia_spmv_2d(data, x, offsets):
    """y = A x for DIA bands data (ndiag, n), x (n,) and static offsets."""
    offsets = tuple(offsets)
    _check(data, x, offsets)
    if x.device.type == "cpu":
        return dia_spmv_plain(data, x, offsets)
    return _launch(data, x, offsets)


def dia_spmv(data, x, offsets):
    """The same product under the 1D TPU kernel's entry name."""
    return dia_spmv_2d(data, x, offsets)
