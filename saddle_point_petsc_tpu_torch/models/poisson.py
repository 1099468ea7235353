"""Vector-Poisson ("stress"/vector-Laplace) problem on a structured grid
(PyTorch twin of `saddle_point_petsc_tpu.models.poisson`).

Unit coefficient, body force f=(1,2) by default, homogeneous Dirichlet
conditions on the whole boundary, domain [0,1]^2. Assembly runs on the
device it is given: batched element matrices, strided-slice stencil
accumulation, symmetric boundary elimination; `assemble_poisson_csr`
builds the same matrix through COO triplets into CSR.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.models import fem
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.stencil import (
    StencilOperator,
    assemble_stencil,
    boundary_mask,
    nodes_to_field,
    stencil_zero_rows_columns,
)
from saddle_point_petsc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """Assembled vector-Poisson problem in stencil form.

    A: StencilOperator (boundary conditions applied, symmetric); f: dof-major
    (2, ny, nx) right-hand side; bc_mask: (ny, nx) boundary-node mask;
    coords: (ny, nx, 2) node coordinates.
    """

    A: StencilOperator
    f: torch.Tensor
    bc_mask: torch.Tensor
    coords: torch.Tensor

    @property
    def grid_shape(self):
        return self.A.grid_shape

    @property
    def n(self):
        return self.A.n


def _body_force(body_force):
    return fem.BODY_FORCES[body_force] if isinstance(body_force, str) else body_force


def assemble_poisson(nex, ney, dtype=torch.float64, device=None, body_force="constant"):
    """Assemble the vector-Poisson system on an nex x ney element grid, on
    `device` (None: the CUDA card, see utils/device.py)."""
    coords = fem.uniform_node_coords(nex, ney, dtype=dtype, device=resolve_device(device))
    ke = fem.batched_element_matrices(coords, nex, ney)
    W = assemble_stencil(ke)
    del ke
    f = nodes_to_field(assemble_rhs(coords, body_force=_body_force(body_force)))
    mask = boundary_mask(ney + 1, nex + 1, device=coords.device)
    W = stencil_zero_rows_columns(W, mask, diag=1.0)
    f = torch.where(mask[None, :, :], 0.0, f)
    return PoissonProblem(StencilOperator.from_block(W), f, mask, coords)


def assemble_rhs(coords, body_force=None):
    """Global load vector as an (ny, nx, 2) field on coords' device and dtype.

    Element load vectors go to the nodes with 4 strided-slice adds.
    """
    if body_force is None:
        body_force = fem.default_body_force
    ny, nx = coords.shape[:2]
    ney, nex = ny - 1, nx - 1
    fe = fem.element_rhs(fem.element_corner_coords(coords), body_force)
    fe = fe.reshape(ney, nex, 4, 2)
    f = torch.zeros((ny, nx, 2), dtype=coords.dtype, device=coords.device)
    for a, (aj, ai) in enumerate(((0, 0), (1, 0), (1, 1), (0, 1))):
        # in place: f is a fresh accumulator owned by this function
        f[aj : aj + ney, ai : ai + nex] += fe[:, :, a]
    return f


def assemble_poisson_csr(nex, ney, dtype=torch.float64, device=None, compact=True):
    """Assemble the same system in CSR form (the general sparse route).

    COO triplets from all elements -> symmetric boundary elimination ->
    sort and deduplicate -> CSR, on `device` (None: the CUDA card);
    `compact` drops the padding.
    Returns (csr, f, mask, coords): f the flat interleaved right-hand side
    of the default body force f = (1, 2) (as the JAX package, this route
    takes no other), mask the (n,) eliminated rows, coords (ny, nx, 2).
    """
    coords = fem.uniform_node_coords(nex, ney, dtype=dtype, device=resolve_device(device))
    ke = fem.batched_element_matrices(coords, nex, ney)
    eq = fem.element_eqnums(nex, ney, device=coords.device)  # (ney, nex, 8)
    rows = eq[..., :, None].expand(*eq.shape, 8).reshape(-1)
    cols = eq[..., None, :].expand(*eq.shape, 8).reshape(-1)
    vals = ke.reshape(-1)
    del ke
    n = (nex + 1) * (ney + 1) * 2
    coo = sparse.COO(rows, cols, vals, (n, n))
    mask_field = boundary_mask(ney + 1, nex + 1, device=coords.device)
    mask = torch.repeat_interleave(mask_field.reshape(-1), 2)
    coo = sparse.coo_zero_rows_columns(coo, mask, diag=1.0)
    csr = sparse.coo_to_csr(coo)
    if compact:
        csr = sparse.csr_compact(csr)
    f = assemble_rhs(coords)
    f = torch.where(mask_field[:, :, None], 0.0, f).reshape(-1)
    return csr, f, mask, coords


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def poisson_problem_from_numpy(planes, f, bc_mask, coords, device=None, dtype=torch.float64):
    """PoissonProblem from assembled numpy arrays (for example the JAX
    package's): planes (4, 3, 3, ny, nx), f (2, ny, nx), bc_mask (ny, nx),
    coords (ny, nx, 2), on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    planes = _tensor(planes, dtype, device)
    if planes.ndim != 5 or tuple(planes.shape[:3]) != (4, 3, 3):
        raise ValueError(f"planes shape {tuple(planes.shape)}, need (4, 3, 3, ny, nx)")
    ny, nx = planes.shape[-2:]
    f = _tensor(f, dtype, device)
    mask = torch.tensor(np.asarray(bc_mask, dtype=bool), device=device)
    coords = _tensor(coords, dtype, device)
    if f.shape != (2, ny, nx) or mask.shape != (ny, nx) or coords.shape != (ny, nx, 2):
        raise ValueError("f, bc_mask and coords do not match the planes' grid")
    return PoissonProblem(StencilOperator(planes), f, mask, coords)

