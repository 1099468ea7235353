r"""Saddle-point (KKT) problem (PyTorch twin of
`saddle_point_petsc_tpu.models.saddle`).

The full KKT system

    [[A, B^T], [B, 0]] (u, lam) = (f, g)

with A the vector-Laplace operator after boundary elimination and B four
integral constraint functionals, restricted to interior dofs:

    row 0  "barycentre-x":  \int Ux dOmega
    row 1  "barycentre-y":  \int Uy dOmega
    row 2  "volume-x":      \int x * Ux dOmega
    row 3  "volume-y":      \int y * Uy dOmega

assembled with the operator's 2x2 Gauss rule.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.models import fem
from saddle_point_petsc_tpu_torch.models.poisson import (
    assemble_poisson,
    poisson_problem_from_numpy,
)
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator
from saddle_point_petsc_tpu_torch.utils import viewers
from saddle_point_petsc_tpu_torch.utils.options import Options
from saddle_point_petsc_tpu_torch.utils.vtk import write_vtk


def default_constraints():
    """The 4 default constraint weight functions (x, y) -> (wx, wy)."""
    return (
        lambda x, y: (torch.ones_like(x), torch.zeros_like(x)),  # barycentre-x
        lambda x, y: (torch.zeros_like(x), torch.ones_like(x)),  # barycentre-y
        lambda x, y: (x, torch.zeros_like(x)),  # volume-x (first moment)
        lambda x, y: (torch.zeros_like(x), y),  # volume-y
    )


def assemble_constraints(coords, constraint_fns=None, bc_mask=None):
    """Constraint rows as dof-major fields Bf (m, 2, ny, nx).

    B[r, dof(a,c)] = sum_e sum_p w_p detJ_p N_a(xi_p) w_c(x_p), scattered
    to the nodes like the load vector. Dirichlet columns are zeroed.
    Runs on coords' device and dtype.
    """
    if constraint_fns is None:
        constraint_fns = default_constraints()
    ny, nx = coords.shape[:2]
    ney, nex = ny - 1, nx - 1
    el_coords = fem.element_corner_coords(coords)  # (ney, nex, 4, 2)
    xi, w = fem.gauss_quadrature_q1(coords.dtype, coords.device)
    ni = fem.shape_q1(xi)  # (gp, 4)
    gni = fem.grad_shape_q1(xi)
    _, det = fem.grad_shape_physical(gni, el_coords[..., None, :, :])
    xp = ni @ el_coords  # (ney, nex, gp, 2)

    rows = []
    for fn in constraint_fns:
        wx, wy = fn(xp[..., 0], xp[..., 1])  # (ney, nex, gp)
        wcomp = torch.stack([wx, wy], dim=-1)  # (ney, nex, gp, 2)
        # per-element nodal weights (ney, nex, 4 nodes, 2 comps)
        be = ni.transpose(0, 1) @ ((w * det)[..., None] * wcomp)
        field = torch.zeros((ny, nx, 2), dtype=coords.dtype, device=coords.device)
        for a, (aj, ai) in enumerate(((0, 0), (1, 0), (1, 1), (0, 1))):
            # in place: field is a fresh accumulator owned by this loop
            field[aj : aj + ney, ai : ai + nex] += be[:, :, a]
        rows.append(field.permute(2, 0, 1))  # dof-major row field
    Bf = torch.stack(rows, dim=0)  # (m, 2, ny, nx)
    if bc_mask is not None:
        Bf = torch.where(bc_mask[None, None, :, :], 0.0, Bf)
    return Bf.contiguous()


@dataclasses.dataclass(frozen=True)
class SaddleProblem:
    """Assembled KKT system: K (u, lam) = (f, g)."""

    K: SaddleOperator  # [[A, B^T], [B, 0]]
    f: torch.Tensor  # dof-major (2, ny, nx) field
    g: torch.Tensor  # (m,)
    bc_mask: torch.Tensor
    coords: torch.Tensor

    @property
    def A(self):
        return self.K.A

    @property
    def B(self):
        return self.K.B

    @property
    def Bf(self):
        return self.K.Bf

    @property
    def rhs(self):
        return (self.f, self.g)

    @property
    def grid_shape(self):
        return tuple(self.f.shape[1:])


def assemble_saddle(
    nex, ney, dtype=torch.float64, device=None, g=None, nconstraints=4, body_force="constant"
):
    """Assemble the full KKT system on an nex x ney element grid.

    g defaults to zeros. With the constant body force f=(1,2), f lies in
    range(B^T) of the default constraints and the solution is u=0,
    lam=(1,2,0,0); body_force="trig" gives a non-trivial constrained solve.
    Runs on `device` (None: the CUDA card, see utils/device.py).
    """
    prob = assemble_poisson(nex, ney, dtype=dtype, device=device, body_force=body_force)
    fns = default_constraints()[:nconstraints]
    Bf = assemble_constraints(prob.coords, fns, prob.bc_mask)
    if g is None:
        g = torch.zeros((Bf.shape[0],), dtype=dtype, device=prob.f.device)
    return SaddleProblem(SaddleOperator(prob.A, Bf), prob.f, g, prob.bc_mask, prob.coords)


def saddle_problem_from_numpy(planes, Bf, f, g, bc_mask, coords, device=None, dtype=torch.float64):
    """SaddleProblem from assembled numpy arrays (for example the JAX
    package's): planes (4, 3, 3, ny, nx), Bf (m, 2, ny, nx), f (2, ny, nx),
    g (m,), bc_mask (ny, nx), coords (ny, nx, 2), on `device` (None: the
    CUDA card)."""
    prob = poisson_problem_from_numpy(planes, f, bc_mask, coords, device=device, dtype=dtype)
    Bf = torch.tensor(np.asarray(Bf), dtype=dtype, device=prob.f.device)
    g = torch.tensor(np.asarray(g).reshape(-1), dtype=dtype, device=prob.f.device)
    if Bf.ndim != 4 or tuple(Bf.shape[1:]) != (2, *prob.grid_shape) or g.shape != Bf.shape[:1]:
        raise ValueError("Bf and g do not match the planes' grid")
    return SaddleProblem(SaddleOperator(prob.A, Bf), prob.f, g, prob.bc_mask, prob.coords)


def solve_saddle_point_problem(
    nex=3,
    ney=3,
    opts=None,
    constraints=True,
    body_force="constant",
    vtk_path=None,
    dtype=torch.float64,
    device=None,
):
    """High-level driver: assemble -> options-configured KSP solve ->
    optional viewers -> optional VTK. `constraints=False` solves the plain
    vector-Poisson system with GMRES/Jacobi; True the full KKT system with
    MINRES/Schur. Runs on `device` (None: the CUDA card). Returns
    (u_field, KrylovResult, problem)."""
    opts = opts if opts is not None else Options()
    if constraints:
        prob = assemble_saddle(nex, ney, dtype=dtype, device=device, body_force=body_force)
        A, b = prob.K, prob.rhs
        default_ksp, default_pc = "minres", "fieldsplit"
    else:
        prob = assemble_poisson(nex, ney, dtype=dtype, device=device, body_force=body_force)
        A, b = prob.A, prob.f
        default_ksp, default_pc = "gmres", "jacobi"
    ksp = KSP(opts)
    ksp.ksp_type, ksp.pc_type = default_ksp, default_pc
    ksp.set_operators(A).set_from_options().set_up()
    viewers.view_from_options(prob.A, opts, "A_mat_view", "A")
    viewers.view_from_options(prob.f, opts, "f_vec_view", "f")
    res = ksp.solve(b)
    u = res.x[0] if constraints else res.x
    viewers.view_from_options(u, opts, "solution_view", "u")
    if vtk_path:
        write_vtk(vtk_path, prob.coords, u)
    return u, res, prob
