"""ILU(0) of a stencil operator with its factors in the planes layout
(PyTorch twin of `saddle_point_petsc_tpu.solvers.ilu_stencil`).

- Factorization (setup, host): the planes are mapped to CSR in the
  natural interleaved ordering (`_slot_table`), factorized in f64 by the
  native IKJ ILU(0) (`precond.factor_values`), and the factored values
  are scattered back into the planes layout: ILU(0) keeps the pattern, so
  L and U keep the stencil structure.
- Application (device): fixed Jacobi sweeps on each triangular factor,

      y <- r - L y            (unit lower, sweeps x)
      z <- D^{-1} (y - U z)   (strict upper, sweeps x)

  where every L and U application is `StencilOperator.matvec_field`:
  kernel B1 on a CUDA device, 2 x sweeps launches an apply.

The parallel block-Jacobi form (`DistILU0PC`, `dist_ilu0`, PETSc's
parallel default bjacobi + ILU(0)): each rank factors its own
patch-truncated patch with `stencil_ilu0_host`, which gives the JAX
package's numbers (it gathers the planes and loops over the patches)
without a gather, and applies the sweeps to its patch: zero collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.ops.stencil import (
    StencilOperator,
    field_to_flat,
    flat_to_field,
)
from saddle_point_petsc_tpu_torch.parallel.dist import patch_truncate
from saddle_point_petsc_tpu_torch.solvers import precond

# Slot masks in planes coordinates (p = 2c + d, dj, di): an entry couples
# row dof (c, j, i) to column dof (d, j+dj-1, i+di-1); in the natural
# interleaved ordering (row = (j*nx + i)*2 + c) "strictly lower" is a
# function of (p, dj, di) alone.
_LMASK = np.zeros((4, 3, 3, 1, 1))
_LMASK[:, 0, :] = 1.0  # dj = -1 rows
_LMASK[:, 1, 0] = 1.0  # same row, di = -1
_LMASK[2, 1, 1] = 1.0  # intra-node (c=1, d=0)
_DMASK = np.zeros((4, 3, 3, 1, 1))
_DMASK[0, 1, 1] = 1.0
_DMASK[3, 1, 1] = 1.0
_UMASK = 1.0 - _LMASK - _DMASK


def _slot_table(my, mx):
    """Map planes slots to CSR (natural interleaved ordering) for an
    (my, mx) grid: returns (indptr, indices, slot), where slot[k] is the
    flat planes index of CSR position k.

    Generated in CSR order, without a sort: within row (j, i, c) the
    column ((j+dj-1)*mx + i+di-1)*2 + d increases with (dj, di, d) taken
    lexicographically, so the in-grid slots enumerated in (j, i, c, dj, di,
    d) order are the rows in order, each with its columns sorted. The JAX
    function builds the same arrays with a lexsort."""
    shape = (my, mx, 2, 3, 3, 2)

    def axis(k, n):
        return np.arange(n, dtype=np.int64).reshape([n if a == k else 1 for a in range(6)])

    j, i, c, dj, di, d = (axis(k, n) for k, n in enumerate(shape))
    jj, ii = j + dj - 1, i + di - 1
    valid = np.broadcast_to((jj >= 0) & (jj < my) & (ii >= 0) & (ii < mx), shape)
    col = np.broadcast_to((jj * mx + ii) * 2 + d, shape)[valid]
    slot = np.broadcast_to(((((2 * c + d) * 3 + dj) * 3 + di) * my + j) * mx + i, shape)[valid]
    counts = valid.reshape(my * mx * 2, 18).sum(1)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return indptr, col.astype(np.int32), slot


def stencil_ilu0_host(lp):
    """ILU(0)-factorize planes (4, 3, 3, my, mx) on the host.

    Returns (Lp, Up_strict, inv_diag) as f64 numpy arrays in the planes
    layout (L multipliers with an implied unit diagonal; strictly upper
    U; the inverted diagonal as a (2, my, mx) field)."""
    lp = np.asarray(lp, np.float64)
    my, mx = lp.shape[-2:]
    indptr, indices, slot = _slot_table(my, mx)
    data = precond.factor_values(indptr, indices, lp.reshape(-1)[slot], my * mx * 2)
    fact = np.zeros(lp.size)
    fact[slot] = data
    fact = fact.reshape(lp.shape)
    Lp = fact * _LMASK
    Up = fact * _UMASK
    diag = np.stack([fact[0, 1, 1], fact[3, 1, 1]])  # (2, my, mx)
    inv_diag = 1.0 / np.where(diag == 0, 1.0, diag)
    return Lp, Up, inv_diag


def _ilu_sweep_local(Lp, Up, invd, r, sweeps):
    """z = U^{-1} L^{-1} r by fixed triangular Jacobi sweeps, every L and U
    application a stencil matvec (kernel B1 on a CUDA device)."""
    L, U = StencilOperator(Lp), StencilOperator(Up)
    y = r
    for _ in range(sweeps):
        y = r - L.matvec_field(y)
    z = invd * y
    for _ in range(sweeps):
        z = invd * (y - U.matvec_field(z))
    return z


@dataclasses.dataclass(frozen=True)
class StencilILU0PC:
    """Serial stencil-form ILU(0), applied by sweeps. At equal sweep counts
    it gives the CSR ILU0PC's iterates, with L and U applied as stencil
    matvecs (no gathers). Takes a (2, ny, nx) field or a flat vector in the
    natural interleaved ordering."""

    Lp: Any  # (4, 3, 3, ny, nx)
    Up: Any
    invd: Any  # (2, ny, nx)
    sweeps: int = 6

    def __call__(self, r):
        flat = r.ndim == 1
        if flat:
            ny, nx = self.Lp.shape[-2:]
            r = flat_to_field(r, ny, nx)
        z = _ilu_sweep_local(self.Lp, self.Up, self.invd, r, self.sweeps)
        return field_to_flat(z) if flat else z


def stencil_ilu0(A: StencilOperator, sweeps=6) -> StencilILU0PC:
    """Serial ILU(0) of a StencilOperator, factored on the host in f64 and
    kept in stencil form on the planes' device in their dtype. As in the
    JAX package, sweeps == 0 applies D^-1 alone; the exact triangular
    solves are the CSR ILU0PC's (`-mat_type aij -pc_ilu_sweeps 0`)."""
    planes = A.planes
    Lp, Up, invd = stencil_ilu0_host(planes.detach().cpu().double().numpy())

    def put(a):
        return torch.tensor(a, dtype=planes.dtype, device=planes.device)

    return StencilILU0PC(put(Lp), put(Up), put(invd), sweeps)


@dataclasses.dataclass(frozen=True)
class DistILU0PC(StencilILU0PC):
    """Distributed block-Jacobi with per-patch ILU(0) local solves: the
    factors of this rank's patch (one block per rank), applied by sweeps
    to its (2, my, mx) patch of the residual with zero collectives (B1 on
    a CUDA device, 2 x sweeps launches an apply). Linear; as PETSc's
    bjacobi + ILU, not symmetric."""


def dist_ilu0(A, sweeps=6) -> DistILU0PC:
    """Per-patch ILU(0) of a DistStencilOperator: patch-truncate (no
    coupling across patches, so every patch is an independent block),
    factor this rank's patch on the host in f64, and keep the factors on
    the planes' device in their dtype."""
    M = stencil_ilu0(StencilOperator(patch_truncate(A).planes), sweeps)
    return DistILU0PC(M.Lp, M.Up, M.invd, sweeps)
