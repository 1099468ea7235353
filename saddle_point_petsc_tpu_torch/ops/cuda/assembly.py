"""Kernel FE, one rank's Q1 assembly on the -dist route, behind a PyTorch
entry point.

`q1_assemble(xs, ys, my, mx, force=None, planes=True, rows=False)` returns
the padded accumulators of the rank's patch, (Wp, load, rows), each None
where not asked for:

- Wp (4, 3, 3, my + 2, mx + 2): the element stiffness matrices of the
  vector-Laplace operator summed into the stencil planes;
- load (2, my + 2, mx + 2): the element loads of the body force named by
  `force` ("constant" or "trig", the formulas of `fem.BODY_FORCES`; None
  for no load);
- rows (4, 2, my + 2, mx + 2): the four default constraint functionals of
  models/saddle.py.

The rank's elements are those whose lower-left node it owns; xs and ys are
their node coordinates, ei + 1 and ej + 1 values sliced from the serial
assembly's `torch.linspace` (ei = ej = 0, with 0 or 1 values, on a patch
holding no element).

It replaces no TPU kernel: the JAX package assembled with XLA einsums. It
takes CUDA tensors only and launches the CUDA kernel in
csrc/q1_assembly.cu, built at first use by `_build`, or raises. The plain
version, the batched element integrals of models/fem.py, is
parallel/dist.py's, which dispatches by device, folds the ghost ring onto
the neighbours and applies the boundary conditions. The kernel's formulas
copy models/fem.py's and models/saddle.py's; tests/test_torch_fe_assembly.py
holds a numpy copy of its arithmetic to the plain version, so a change to
either shows there. Each launch adds 1, in `utils.monitor.counters`, to
`FE.launches` and to `FE.launches.float32` or `FE.launches.float64`.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.utils import monitor

_DTYPES = (torch.float32, torch.float64)
_DTYPE_KEY = {torch.float32: "FE.launches.float32", torch.float64: "FE.launches.float64"}
# the body forces the kernel computes, by name, and their codes
# (csrc/q1_assembly.cu, Force)
FORCES = {"constant": 1, "trig": 2}


def _check(xs, ys, my, mx, force):
    """Validate types, dtype, sizes, contiguity and device; raise otherwise."""
    if not isinstance(xs, torch.Tensor) or not isinstance(ys, torch.Tensor):
        raise TypeError("q1_assemble takes torch tensors")
    if xs.device != ys.device:
        raise ValueError(f"xs on {xs.device}, ys on {ys.device}")
    if xs.dtype not in _DTYPES or ys.dtype != xs.dtype:
        raise TypeError(f"xs {xs.dtype} and ys {ys.dtype}: need one of float32, float64 for both")
    if xs.ndim != 1 or ys.ndim != 1:
        raise ValueError(f"xs {tuple(xs.shape)} and ys {tuple(ys.shape)}: need 1-D node coordinates")
    if not (isinstance(my, int) and isinstance(mx, int) and my >= 1 and mx >= 1):
        raise ValueError(f"patch ({my}, {mx}): need positive int node counts")
    if ys.numel() > my + 1 or xs.numel() > mx + 1:
        raise ValueError(f"{ys.numel()} x {xs.numel()} node coordinates span more elements than a "
                         f"({my}, {mx}) patch owns")
    if not (xs.is_contiguous() and ys.is_contiguous()):
        raise ValueError("q1_assemble needs contiguous xs and ys")
    if not (force is None or force in FORCES):
        raise ValueError(f"body force {force!r}: need one of {sorted(FORCES)} or None")
    if xs.device.type != "cuda":
        raise ValueError(f"q1_assemble takes CUDA tensors, not {xs.device}: the plain version is "
                         "parallel/dist.py's")


_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("q1_assembly")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("q1_assembly_f32", "q1_assembly_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def q1_assemble(xs, ys, my, mx, force=None, planes=True, rows=False):
    """(Wp, load, rows) of one rank's patch, padded, in one launch; see the
    module docstring."""
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    _check(xs, ys, my, mx, force)
    lib = _library()
    ej, ei = max(ys.numel() - 1, 0), max(xs.numel() - 1, 0)

    def out(*lead):
        return torch.empty((*lead, my + 2, mx + 2), dtype=xs.dtype, device=xs.device)

    Wp = out(4, 3, 3) if planes else None
    load = out(2) if force else None
    Bp = out(4, 2) if rows else None
    fn = lib.q1_assembly_f32 if xs.dtype == torch.float32 else lib.q1_assembly_f64
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = fn(xs.data_ptr(), ys.data_ptr(), ej, ei, my, mx, FORCES.get(force, 0),
                *(0 if t is None else t.data_ptr() for t in (Wp, load, Bp)), stream)
    _build.check(lib, "q1_assembly", rc)
    monitor.count("FE.launches")
    monitor.count(_DTYPE_KEY[xs.dtype])
    return Wp, load, Bp
