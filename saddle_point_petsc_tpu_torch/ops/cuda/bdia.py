"""Kernel B4, the block-DIA SpMV on a dof-major vector, behind one PyTorch
entry point.

- `bdia_spmv_2d(data, xb, offsets, active)`: twin of `bdia_spmv_pallas_2d`,
  the TPU kernel `_bdia2d_kernel` (saddle_point_petsc_tpu/ops/pallas/spmv.py).

For block bands data (ndiag, b, b, mb), a dof-major vector xb (b, mb),
static block offsets and the active (k, c, d) triples,
y[c, i] = sum over active (k, c, d) of data[k, c, d, i] * xb[d, i + offsets[k]],
with xb taken as 0 outside [0, mb), each y[c] summed in `active` order.
On CPU tensors it runs the plain PyTorch version `bdia_spmv_plain`; on CUDA
tensors it launches the kernel of csrc/bdia_spmv.cu, built at first use by
`_build`, or raises. Each launch adds 1 to
`B4.launches` in `utils.monitor.counters`.
"""
from __future__ import annotations

import torch

from saddle_point_petsc_tpu_torch.utils import monitor


_DTYPES = (torch.float32, torch.float64)
_lib = None
_tables = {}  # (offsets, active, b, device) -> int32 triple table on that device


def bdia_spmv_plain(data, xb, offsets, active):
    """The plain version: one shifted multiply-add per active triple, in
    `active` order, as the XLA chain of the JAX package's
    `bdia_matvec_dofmajor` (ops/sparse.py) sums them."""
    b, mb = xb.shape
    ys = [torch.zeros((mb,), dtype=xb.dtype, device=xb.device) for _ in range(b)]
    for k, c, d in active:
        off = offsets[k]
        w = data[k, c, d]
        xd = xb[d]
        if abs(off) >= mb:
            continue
        if off == 0:
            ys[c] = ys[c] + w * xd
        elif off > 0:
            ys[c][: mb - off] += w[: mb - off] * xd[off:]  # in place: ys[c] is ours
        else:
            ys[c][-off:] += w[-off:] * xd[: mb + off]
    return torch.stack(ys)


def _check(data, xb, offsets, active):
    """Validate device, dtype, contiguity, shapes and triples; raise otherwise."""
    if not isinstance(data, torch.Tensor) or not isinstance(xb, torch.Tensor):
        raise TypeError("bdia_spmv takes torch tensors")
    if data.device != xb.device:
        raise ValueError(f"data on {data.device}, xb on {xb.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype not in _DTYPES or xb.dtype != data.dtype:
        raise TypeError(
            f"data {data.dtype} and xb {xb.dtype}: need one of float32, float64 for both"
        )
    if xb.ndim != 2 or xb.shape[0] < 1 or xb.shape[1] < 1:
        raise ValueError(f"xb shape {tuple(xb.shape)}, need (b, mb) with b, mb >= 1")
    b, mb = xb.shape
    if tuple(data.shape) != (len(offsets), b, b, mb):
        raise ValueError(
            f"data shape {tuple(data.shape)}, need (len(offsets), b, b, mb) = "
            f"({len(offsets)}, {b}, {b}, {mb})"
        )
    if not all(isinstance(o, int) and abs(o) < 2**31 for o in offsets):
        raise ValueError("offsets must be a tuple of 32-bit Python ints")
    if not (data.is_contiguous() and xb.is_contiguous()):
        raise ValueError("bdia_spmv needs contiguous data and xb")


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from saddle_point_petsc_tpu_torch.ops.cuda import _build

        lib = _build.load_library("bdia_spmv")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("bdia_spmv_f32", "bdia_spmv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def triples_table(offsets, active, b):
    """The kernel's triple table as a list of ints: starts (b+1), then per
    triple grouped by c in `active` order its offset, its plane index
    (k*b + c)*b + d into data viewed as (ndiag*b*b, mb), and its dof d."""
    for k, c, d in active:
        if not (0 <= k < len(offsets) and 0 <= c < b and 0 <= d < b):
            raise ValueError(f"active triple {(k, c, d)} out of range")
    grouped = [[(k, d) for k, cc, d in active if cc == c] for c in range(b)]
    starts, off, plane, dof = [0], [], [], []
    for c in range(b):
        for k, d in grouped[c]:
            off.append(offsets[k])
            plane.append((k * b + c) * b + d)
            dof.append(d)
        starts.append(len(off))
    return starts + off + plane + dof


def _table_on(offsets, active, b, device):
    key = (offsets, active, b, device)
    if key not in _tables:
        _tables[key] = torch.tensor(
            triples_table(offsets, active, b), dtype=torch.int32, device=device
        )
    return _tables[key]


def _launch(data, xb, offsets, active):
    from saddle_point_petsc_tpu_torch.ops.cuda import _build

    lib = _library()
    b, mb = xb.shape
    table = _table_on(offsets, active, b, xb.device)
    y = torch.empty_like(xb)
    fn = lib.bdia_spmv_f32 if xb.dtype == torch.float32 else lib.bdia_spmv_f64
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        rc = fn(data.data_ptr(), xb.data_ptr(), y.data_ptr(), table.data_ptr(),
                b, len(active), mb, stream)
    _build.check(lib, "bdia_spmv", rc)
    monitor.count("B4.launches")
    return y


def bdia_spmv_2d(data, xb, offsets, active):
    """y = A xb for block-DIA bands data (ndiag, b, b, mb) and xb (b, mb)."""
    offsets, active = tuple(offsets), tuple(tuple(t) for t in active)
    _check(data, xb, offsets, active)
    if xb.device.type == "cpu":
        return bdia_spmv_plain(data, xb, offsets, active)
    return _launch(data, xb, offsets, active)
