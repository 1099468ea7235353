"""Kernel B2, the planes-layout stencil SpMM, behind a PyTorch entry point.

`stencil_spmm(planes, XT)`: Y[k] = A XT[k] for planes (4, 3, 3, ny, nx) and
a batch of k dof-major fields XT (k, 2, ny, nx), with out-of-grid
neighbours taken as zero. It replaces the TPU kernel
`_stencil_spmm_kernel` (saddle_point_petsc_tpu/ops/pallas/spmm.py). On CPU
tensors it runs the plain PyTorch version `planes_matmat_field` (from
ops/stencil.py, re-exported here); on CUDA tensors it launches the CUDA
kernel in csrc/stencil_spmm.cu, built at first use by `_build`, or raises.
Each launch adds 1 to `B2.launches` in `utils.monitor.counters`.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.ops.stencil import planes_matmat_field  # noqa: F401
from saddle_point_petsc_tpu_torch.utils import monitor


_DTYPES = (torch.float32, torch.float64)
_lib = None


def _check(planes, XT):
    """Validate device, dtype, contiguity and shapes; raise otherwise."""
    if not isinstance(planes, torch.Tensor) or not isinstance(XT, torch.Tensor):
        raise TypeError("stencil_spmm takes torch tensors")
    if planes.device != XT.device:
        raise ValueError(f"planes on {planes.device}, XT on {XT.device}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes.device}")
    if planes.dtype not in _DTYPES or XT.dtype != planes.dtype:
        raise TypeError(
            f"planes {planes.dtype} and XT {XT.dtype}: need one of float32, "
            "float64 for both"
        )
    if planes.ndim != 5 or tuple(planes.shape[:3]) != (4, 3, 3):
        raise ValueError(f"planes shape {tuple(planes.shape)}, need (4, 3, 3, ny, nx)")
    ny, nx = planes.shape[-2:]
    if ny < 1 or nx < 1:
        raise ValueError("empty grid")
    if XT.ndim != 4 or XT.shape[0] < 1 or tuple(XT.shape[1:]) != (2, ny, nx):
        raise ValueError(f"XT shape {tuple(XT.shape)}, need (k, 2, {ny}, {nx}) with k >= 1")
    if not (planes.is_contiguous() and XT.is_contiguous()):
        raise ValueError("stencil_spmm needs contiguous planes and XT")


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("stencil_spmm")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("stencil_spmm_f32", "stencil_spmm_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def _launch(planes, XT):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = _library()
    k = XT.shape[0]
    ny, nx = planes.shape[-2:]
    Y = torch.empty_like(XT)
    fn = lib.stencil_spmm_f32 if planes.dtype == torch.float32 else lib.stencil_spmm_f64
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = fn(planes.data_ptr(), XT.data_ptr(), Y.data_ptr(), k, ny, nx, stream)
    _build.check(lib, "stencil_spmm", rc)
    monitor.count("B2.launches")
    return Y


def stencil_spmm(planes, XT):
    """Y = A X for planes (4, 3, 3, ny, nx) and a batch XT (k, 2, ny, nx),
    zero boundary; returns (k, 2, ny, nx)."""
    _check(planes, XT)
    if planes.device.type == "cpu":
        return planes_matmat_field(planes, XT)
    return _launch(planes, XT)
