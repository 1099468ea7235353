"""Flag-gated object viewers (PyTorch twin of
`saddle_point_petsc_tpu.utils.viewers`, PETSc {Mat,Vec}ViewFromOptions).

When the flag is in the options database, dump the object: ASCII to
stdout by default, or to `path:npz` / `path.txt` style targets. Above
`DENSE_LIMIT` rows a StencilOperator, CSR, DIA or block-DIA operator is
dumped as (row, col, value) triplets instead of being densified.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.ops import sparse as sp
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator, stencil_to_coo

# above this many rows, sparse operators are viewed as COO triplets
DENSE_LIMIT = 16384


def _resolve_target(value):
    if value in ("", "ascii", "stdout"):
        return None, "ascii"
    if ":" in value:
        path, fmt = value.rsplit(":", 1)
        return path, fmt
    return value, "txt"


def view_from_options(obj, opts, flag, name=""):
    """Dump `obj` (a tensor or a sparse operator) if `flag` is present."""
    if not opts.has(flag):
        return False
    target, fmt = _resolve_target(opts.get_str(flag, ""))
    kind, payload = _to_view(obj)
    name = name or flag
    if target is None:
        _print_view(kind, payload, name, sys.stdout)
    elif fmt == "npz":
        if kind == "coo":
            np.savez(target, **{f"{name}_{k}": v for k, v in payload.items()})
        else:
            np.savez(target, **{name or "data": payload})
    else:
        with open(target, "w") as f:
            _print_view(kind, payload, name, f)
    return True


def _to_view(obj):
    """Lower `obj` to ("dense", ndarray) or ("coo", dict) for display."""
    if isinstance(obj, StencilOperator):
        rows, cols, vals = stencil_to_coo(obj.W)
        if obj.n <= DENSE_LIMIT:
            keep = rows >= 0
            dense = np.zeros((obj.n, obj.n), vals.dtype)
            np.add.at(dense, (rows[keep], cols[keep]), vals[keep])
            return "dense", dense
        return "coo", _coo_payload(rows, cols, vals, (obj.n, obj.n))
    if isinstance(obj, (sp.CSR, sp.DIA, sp.BDIA)):
        if obj.shape[0] <= DENSE_LIMIT:
            return "dense", obj.todense().detach().cpu().numpy()
        a = sp.to_scipy(obj).tocoo()
        return "coo", _coo_payload(a.row, a.col, a.data, obj.shape)
    if isinstance(obj, torch.Tensor):
        return "dense", obj.detach().cpu().numpy()
    return "dense", np.asarray(obj)


def _coo_payload(row, col, data, shape):
    # drop padding (row < 0) and explicit zeros (stencil planes store the
    # full 3x3x2x2 box even where entries vanish, e.g. outside the grid)
    keep = (data != 0) & (row >= 0)
    return {
        "row": row[keep],
        "col": col[keep],
        "data": data[keep],
        "shape": np.asarray(shape),
    }


def _print_view(kind, payload, name, file):
    if kind == "dense":
        print(f"{name} = [{payload.shape}]", file=file)
        with np.printoptions(precision=6, suppress=False, threshold=10000):
            print(payload, file=file)
        return
    shape = tuple(payload["shape"])
    nnz = payload["data"].shape[0]
    print(f"{name} = sparse {shape[0]}x{shape[1]}, nnz={nnz}", file=file)
    # PETSc-ish "row (col, value) ..." lines, truncated for stdout sanity
    limit = 10000
    row, col, data = payload["row"], payload["col"], payload["data"]
    order = np.lexsort((col, row))
    cur = -1
    parts = []
    for k in order[:limit]:
        if row[k] != cur:
            if parts:
                print(" ".join(parts), file=file)
            cur = int(row[k])
            parts = [f"row {cur}:"]
        parts.append(f"({int(col[k])}, {data[k]:.6g})")
    if parts:
        print(" ".join(parts), file=file)
    if nnz > limit:
        print(f"... ({nnz - limit} more entries; use :path.npz for all)", file=file)
