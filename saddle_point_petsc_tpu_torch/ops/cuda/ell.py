"""Kernel B5, the ELL SpMV, behind a PyTorch entry point.

`ell_spmv(cols_t, vals_t, x)`: y[i] = sum_s vals_t[s, i] * x[cols_t[s, i]]
over the slot-major (transposed) ELL arrays cols_t (K, m) int32 and
vals_t (K, m), where cols_t < 0 marks a padding slot, for x (n,). It
replaces the TPU kernel `_ell_kernel` (saddle_point_petsc_tpu/ops/pallas/
spmv.py), which takes the same layout (`ell_transpose`). On CPU tensors it
runs the plain PyTorch version `ell_spmv_plain`; on CUDA tensors it
launches the CUDA kernel in csrc/ell_spmv.cu, built at first use by
`_build`, or raises. Each launch adds 1 to
`B5.launches` in `utils.monitor.counters`.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.utils import monitor


_DTYPES = (torch.float32, torch.float64)
_lib = None


def ell_spmv_plain(cols_t, vals_t, x):
    """The plain version: one gather and multiply-add per slot, slots in
    order, so each row is summed sequentially as the kernel sums it."""
    y = torch.zeros((cols_t.shape[1],), dtype=x.dtype, device=x.device)
    for c, v in zip(cols_t, vals_t):
        y = y + torch.where(c >= 0, v, 0.0) * x[c.clamp_min(0)]
    return y


def _check(cols_t, vals_t, x):
    """Validate device, dtype, contiguity and shapes; raise otherwise."""
    if not all(isinstance(t, torch.Tensor) for t in (cols_t, vals_t, x)):
        raise TypeError("ell_spmv takes torch tensors")
    if not cols_t.device == vals_t.device == x.device:
        raise ValueError(f"cols_t on {cols_t.device}, vals_t on {vals_t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES or vals_t.dtype != x.dtype:
        raise TypeError(
            f"vals_t {vals_t.dtype} and x {x.dtype}: need one of float32, float64 for both"
        )
    if cols_t.dtype != torch.int32:
        raise TypeError(f"cols_t {cols_t.dtype}, need int32")
    if cols_t.ndim != 2 or cols_t.shape[1] < 1 or vals_t.shape != cols_t.shape:
        raise ValueError(
            f"cols_t {tuple(cols_t.shape)} and vals_t {tuple(vals_t.shape)}: need "
            "one (K, m) shape with m >= 1"
        )
    if x.ndim != 1:
        raise ValueError(f"x shape {tuple(x.shape)}, need (n,)")
    if not (cols_t.is_contiguous() and vals_t.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv needs contiguous cols_t, vals_t and x")


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("ell_spmv")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("ell_spmv_f32", "ell_spmv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def _launch(cols_t, vals_t, x):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = _library()
    nslots, m = cols_t.shape
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    fn = lib.ell_spmv_f32 if x.dtype == torch.float32 else lib.ell_spmv_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(cols_t.data_ptr(), vals_t.data_ptr(), x.data_ptr(), y.data_ptr(),
                nslots, m, stream)
    _build.check(lib, "ell_spmv", rc)
    monitor.count("B5.launches")
    return y


def ell_spmv(cols_t, vals_t, x):
    """y = A x for slot-major ELL arrays cols_t (K, m) int32, vals_t (K, m)
    and x (n,); returns (m,)."""
    _check(cols_t, vals_t, x)
    if x.device.type == "cpu":
        return ell_spmv_plain(cols_t, vals_t, x)
    return _launch(cols_t, vals_t, x)
