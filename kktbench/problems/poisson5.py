"""The 2-D 5-point Laplacian of PETSc's KSP tutorial ex2.c as a
row-partitioned matrix (MATMPIAIJ), as the harness needs it: the
program's assembly, a load's right-hand side, the answer a solve hands
back, and the check against the plain reference
(kktbench/reference/poisson5.py).

A configuration names it with `"problem": "poisson5"`. `grid_nodes` n
counts the nodes of a side, boundary included: the boundary nodes are the
eliminated Dirichlet rows, so the matrix has (n - 2)^2 rows, one an
interior node (j, i) at row (j - 1) (n - 2) + (i - 1), with 4 on the
diagonal and -1 at each interior neighbour.

Layouts, beside q1kkt's (2, my, mx) patch and multipliers:

- `assemble` returns the program's `DistAIJ` over a (1, world) mesh,
  this rank's rows built by `dist_csr.dist_aij_from_rows` (PETSc's
  MatCreateMPIAIJWithArrays after each rank's MatSetValues loop); no rank
  builds the global matrix. It runs under the program's span
  `MatAssembly`, once a system, as ex2.c's MatAssemblyBegin/End; the
  DistAIJ builds of the gamg set-up run under `GAMGLevelBuild Lk`.
- `rhs` is this rank's rows of the interior of the load's single
  component, `loads.field(key, 1, ...)`, zero-padded to the DistAIJ's
  rows (`dist_csr.pad_vector`): the vector `KSP.solve` takes.
- `answer` is `(u,)`: the solution as a (1, n, n) node field with a zero
  boundary, the layout `runner.gathered` and the check take. It reads
  the whole solution from this rank, so it serves a world of one.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sps
import torch
import torch.nn.functional as F

from kktbench import loads as L
from kktbench.reference.poisson5 import Reference
from saddle_point_petsc_tpu_torch.parallel import dist_csr
from saddle_point_petsc_tpu_torch.utils import monitor

# the compared numbers the check can give (a configuration's `limits` pick)
NUMBERS = ("err", "resid_smooth")


def rows(m, lo, hi):
    """Rows lo .. hi - 1 of the 5-point operator on the m x m interior
    grid, as a (hi - lo, m^2) scipy CSR with global columns: one rank's
    MatSetValues loop, vectorised."""
    r = np.arange(lo, hi, dtype=np.int64)
    j, i = np.divmod(r, m)
    cols = [r, r - m, r + m, r - 1, r + 1]
    keep = [np.ones(len(r), bool), j > 0, j < m - 1, i > 0, i < m - 1]
    vals = [4.0, -1.0, -1.0, -1.0, -1.0]
    local = np.concatenate([(r - lo)[k] for k in keep])
    col = np.concatenate([c[k] for c, k in zip(cols, keep)])
    val = np.concatenate([np.full(int(k.sum()), v) for v, k in zip(vals, keep)])
    return sps.csr_matrix((val, (local, col)), shape=(hi - lo, m * m))


def assemble(n, mesh, dtype):
    """The program's 5-point operator of an n x n node grid: this rank's
    rows on a (1, world) mesh over the run's process group, on `mesh`'s
    device."""
    m = n - 2
    with monitor.span("MatAssembly"):
        mesh1 = dist_csr.make_mesh_1d(device=mesh.device)
        n_loc = -(-(m * m) // mesh1.size)
        lo = mesh1.rank * n_loc
        block = rows(m, min(lo, m * m), min(lo + n_loc, m * m))
        block = sps.vstack([block, sps.csr_matrix((n_loc - block.shape[0], m * m))]).tocsr()
        return dist_csr.dist_aij_from_rows(block, m * m, mesh1, dtype=dtype)


def rhs(loads, key, K, dtype, device):
    """This rank's rows of the interior of the load `key`, padded."""
    n = loads.n
    f = loads.field(key, 1, (0, 0), (n, n), dtype, device)[0, 1:-1, 1:-1].reshape(-1)
    return dist_csr.pad_vector(f, K.n_pad, K.mesh)


def answer(res):
    """The solution as (a (1, n, n) node field, zero on the boundary,)."""
    m = math.isqrt(res.x.shape[0])
    return (F.pad(res.x[: m * m].reshape(1, m, m), (1, 1, 1, 1)),)


class Check:
    """The reference of an n x n grid in float64 on `device`."""

    def __init__(self, n, device):
        self.ref = Reference(n, device=device)

    def numbers(self, u, loads, key):
        """The compared numbers of the whole-grid answer u (1, n, n) to the
        load `key`."""
        a = torch.tensor(L.amplitudes(loads.seed, key, 1, loads.modes)[0], device=self.ref.device)
        return self.ref.numbers(u[0], a)
