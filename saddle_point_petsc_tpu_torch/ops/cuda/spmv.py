"""Kernel B1, the planes-layout stencil SpMV, behind two PyTorch entry points.

- `stencil_spmv(planes, x)`: y = A x on a (2, ny, nx) field, with
  out-of-grid neighbours taken as zero.
- `stencil_spmv_padded(planes, xp)`: the same on a halo-padded
  (2, ny+2, nx+2) field, whose ring holds the neighbours' values.

Both replace the TPU kernel `_stencil_kernel`
(saddle_point_petsc_tpu/ops/pallas/spmv.py). On CPU tensors they run the
plain PyTorch versions, `planes_matvec_field` and `planes_matvec_padded`
(from ops/stencil.py, re-exported here). On CUDA tensors they launch the
CUDA kernel in csrc/stencil_spmv.cu, built at first use by `_build`, or
raise. Each launch adds 1, in `utils.monitor.counters`, to `B1.launches`,
to `B1.launches.local` or `B1.launches.padded` by entry point, and to
`B1.launches.float32` or `B1.launches.float64` by type.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.ops.stencil import (  # noqa: F401
    planes_matvec_field,
    planes_matvec_padded,
)
from saddle_point_petsc_tpu_torch.utils import monitor

_DTYPES = (torch.float32, torch.float64)
# the counter keys of a launch, by entry (padded or not) and by type
_ENTRY_KEY = {False: "B1.launches.local", True: "B1.launches.padded"}
_DTYPE_KEY = {torch.float32: "B1.launches.float32", torch.float64: "B1.launches.float64"}


def _check(planes, x, halo):
    """Validate device, dtype, contiguity and shapes; raise otherwise."""
    if not isinstance(planes, torch.Tensor) or not isinstance(x, torch.Tensor):
        raise TypeError("stencil_spmv takes torch tensors")
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device}, x on {x.device}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes.device}")
    if planes.dtype not in _DTYPES or x.dtype != planes.dtype:
        raise TypeError(
            f"planes {planes.dtype} and x {x.dtype}: need one of float32, "
            "float64 for both"
        )
    if planes.ndim != 5 or tuple(planes.shape[:3]) != (4, 3, 3):
        raise ValueError(f"planes shape {tuple(planes.shape)}, need (4, 3, 3, ny, nx)")
    ny, nx = planes.shape[-2:]
    want = (2, ny + 2 * halo, nx + 2 * halo)
    if tuple(x.shape) != want:
        raise ValueError(f"x shape {tuple(x.shape)}, need {want}")
    if ny < 1 or nx < 1:
        raise ValueError("empty grid")
    if not (planes.is_contiguous() and x.is_contiguous()):
        raise ValueError("stencil_spmv needs contiguous planes and x")


_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("stencil_spmv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("stencil_spmv_f32", "stencil_spmv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def _launch(planes, x, padded):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = _library()
    ny, nx = planes.shape[-2:]
    y = torch.empty((2, ny, nx), dtype=planes.dtype, device=planes.device)
    fn = lib.stencil_spmv_f32 if planes.dtype == torch.float32 else lib.stencil_spmv_f64
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = fn(planes.data_ptr(), x.data_ptr(), y.data_ptr(), ny, nx, int(padded), stream)
    _build.check(lib, "stencil_spmv", rc)
    monitor.count("B1.launches")
    monitor.count(_ENTRY_KEY[padded])
    monitor.count(_DTYPE_KEY[planes.dtype])
    return y


def stencil_spmv(planes, x):
    """y = A x for planes (4, 3, 3, ny, nx) and x (2, ny, nx), zero boundary."""
    _check(planes, x, halo=0)
    if planes.device.type == "cpu":
        return planes_matvec_field(planes, x)
    return _launch(planes, x, padded=False)


def stencil_spmv_padded(planes, xp):
    """y = A x for planes (4, 3, 3, ny, nx) and halo-padded xp (2, ny+2, nx+2)."""
    _check(planes, xp, halo=1)
    if planes.device.type == "cpu":
        return planes_matvec_padded(planes, xp)
    return _launch(planes, xp, padded=True)
