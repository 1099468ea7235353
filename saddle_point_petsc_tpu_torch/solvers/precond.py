"""Preconditioners, main-path subset (PyTorch twin of
`saddle_point_petsc_tpu.solvers.precond`).

IdentityPC, JacobiPC/jacobi (stencil, CSR, DIA, block-DIA), inv_small,
ChebyshevPC/chebyshev_pc (the gamg smoother) and the fieldsplit Schur
preconditioner SchurPC/schur_pc for the KKT system. Each PC is a frozen
dataclass holding tensors, with `__call__(r) -> z` over the same vector
structure the Krylov solvers use (a tensor or a tuple of tensors). The
rest of the JAX module (point-block and block Jacobi, ILU(0), SOR,
estimate_lmax, fieldsplit on the stencil, inner KSP) is still to be
ported; see ROADMAP.md queue A.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from saddle_point_petsc_tpu_torch.ops import sparse as sp
from saddle_point_petsc_tpu_torch.solvers.krylov import chebyshev_iterate
from saddle_point_petsc_tpu_torch.solvers.operators import (
    constraint_apply,
    constraint_apply_t,
)


@dataclasses.dataclass(frozen=True)
class IdentityPC:
    def __call__(self, r):
        return r


@dataclasses.dataclass(frozen=True)
class JacobiPC:
    """Diagonal scaling z = D^{-1} r (PETSc PCJACOBI)."""

    inv_diag: Any  # same structure as the vectors

    def __call__(self, r):
        if isinstance(r, tuple):
            return tuple(d * x for d, x in zip(self.inv_diag, r))
        return self.inv_diag * r


def _inv_diag(A):
    d = sp.csr_extract_diagonal(A) if isinstance(A, sp.CSR) else A.diagonal()
    return 1.0 / torch.where(d == 0, 1.0, d)


def jacobi(A) -> JacobiPC:
    """Jacobi PC of a CSR or of any operator exposing .diagonal()."""
    return JacobiPC(_inv_diag(A))


@dataclasses.dataclass(frozen=True)
class ChebyshevPC:
    """A fixed number of Chebyshev iterations with an inner PC (e.g. Jacobi):
    the gamg level smoother, free of inner products."""

    A: Any
    inner: Any
    lmin: float
    lmax: float
    iters: int

    def __call__(self, r):
        return chebyshev_iterate(
            self.A, r, M=self.inner, lmin=self.lmin, lmax=self.lmax, maxiter=self.iters
        )


def chebyshev_pc(A, inner=None, lmin=0.1, lmax=1.1, iters=3) -> ChebyshevPC:
    if inner is None:
        inner = jacobi(A)
    return ChebyshevPC(A, inner, lmin, lmax, iters)


def inv_small(M):
    """Inverse of small trailing (b, b) blocks without LU.

    b == 1 and 2 use the closed-form adjugate; larger b uses unrolled
    Gauss-Jordan with diagonal pivots, valid for the definite blocks this
    library inverts (diagonal blocks, Schur complements).
    """
    b = M.shape[-1]
    if b == 1:
        return 1.0 / M
    if b == 2:
        a, bb = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - bb * c
        adj = torch.stack([torch.stack([d, -bb], -1), torch.stack([-c, a], -1)], -2)
        return adj / det[..., None, None]
    eye = torch.eye(b, dtype=M.dtype, device=M.device).expand(M.shape)
    aug = torch.cat([M, eye], dim=-1)  # fresh tensor, updated in place below
    for i in range(b):
        row = aug[..., i, :] / aug[..., i, i][..., None]
        aug[..., i, :] = row
        for j in range(b):
            if j != i:
                aug[..., j, :] = aug[..., j, :] + (-aug[..., j, i][..., None] * row)
    return aug[..., b:]


@dataclasses.dataclass(frozen=True)
class SchurPC:
    """Fieldsplit Schur-complement PC for [[A, B^T], [B, 0]] on (u, lam).

    PETSc PCFIELDSPLIT with -pc_fieldsplit_type schur and the approximation
    S ~= -B diag(A)^{-1} B^T. `fact_type` mirrors
    -pc_fieldsplit_schur_fact_type: diag | lower | upper | full. MINRES
    needs "diag" (an SPD PC, using |S|).

    inner_solve: callable r_u -> approx A^{-1} r_u. S_inv: (m, m) dense
    inverse of the Schur approximation.
    """

    inner_solve: Any
    Bf: torch.Tensor  # (m, 2, ny, nx)
    S_inv: torch.Tensor  # (m, m)
    fact_type: str = "full"

    def __post_init__(self):
        if self.fact_type not in ("diag", "lower", "upper", "full"):
            raise ValueError(f"unknown Schur fact_type {self.fact_type!r}")

    def __call__(self, r):
        ru, rlam = r
        Ainv = self.inner_solve
        if self.fact_type == "diag":
            # the lambda block uses +(B D^-1 B^T)^-1 = -S_inv, since
            # S = -B D^-1 B^T is negative definite
            return (Ainv(ru), -(self.S_inv @ rlam))
        if self.fact_type == "lower":
            zu = Ainv(ru)
            return (zu, self.S_inv @ (rlam - constraint_apply(self.Bf, zu)))
        if self.fact_type == "upper":
            zlam = self.S_inv @ rlam
            return (Ainv(ru - constraint_apply_t(self.Bf, zlam)), zlam)
        # full: L-D-U application
        yu = Ainv(ru)
        zlam = self.S_inv @ (rlam - constraint_apply(self.Bf, yu))
        return (yu - Ainv(constraint_apply_t(self.Bf, zlam)), zlam)


def schur_pc(A, Bf, inner_solve=None, fact_type="full") -> SchurPC:
    """Schur PC with S = -B diag(A)^{-1} B^T (dense m x m).

    A: operator exposing .diagonal() as a (2, ny, nx) field; Bf: the
    constraint rows (m, 2, ny, nx)."""
    dinv = _inv_diag(A)
    B2 = Bf.reshape(Bf.shape[0], -1)
    S = -((B2 * dinv.reshape(-1)) @ B2.transpose(0, 1))  # negative definite
    if inner_solve is None:
        inner_solve = JacobiPC(dinv)
    return SchurPC(inner_solve, Bf, inv_small(S), fact_type)
