"""Geometric multigrid on stencil operators, serial (PyTorch twin of
`saddle_point_petsc_tpu.solvers.multigrid`).

- Prolongation is bilinear interpolation on the nested node grids (coarse
  spacing 2); restriction is its exact adjoint P^T. Both are strided-slice
  tensor operations.
- Coarse operators are Galerkin products A_c = P^T A P in stencil form,
  in closed form: 169 strided-slice multiply-adds on coarse-sized planes
  per level, on the operator's device (`galerkin_coarse_stencil`; the
  comb-probing form `galerkin_coarse_stencil_probe` cross-checks it).
- Smoothers: red-black block SOR (symmetric, or forward before and
  backward after), Chebyshev(3) over Jacobi on [lmax/4, lmax] with a
  per-level power-iteration bound, or damped point-block Jacobi.
- Coarsest level: a dense inverse computed on the host at setup, applied
  with `torch.matmul`.

Every level's stencil matvec, in the residuals and in the smoothers, goes
through `StencilOperator`: kernel B1 on a CUDA device. The V-cycle is
linear and symmetric (for the symmetric smoothers), so it is a valid
CG/MINRES preconditioner. Grids coarsen only while the node counts are
odd: 2^k + 1 nodes per side coarsen all the way. The distributed
hierarchy (`DistMGPC`, `mg_pc_dist`) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from saddle_point_petsc_tpu_torch.ops.stencil import (
    StencilOperator,
    field_to_flat,
    flat_to_field,
)
from saddle_point_petsc_tpu_torch.solvers import precond


def prolong(xc, ny, nx):
    """Bilinear interpolation on the last two (spatial) dims:
    (..., nyc, nxc) -> (..., ny, nx) with ny = 2*nyc-1, nx = 2*nxc-1
    (nested node grids). Works on dof-major (2, nyc, nxc) fields."""
    xf = xc.new_zeros(xc.shape[:-2] + (ny, nx))
    # in place: xf is a fresh tensor owned by this function
    xf[..., 0::2, 0::2] = xc
    xf[..., 0::2, 1::2] = 0.5 * (xc[..., :, :-1] + xc[..., :, 1:])
    xf[..., 1::2, 0::2] = 0.5 * (xc[..., :-1, :] + xc[..., 1:, :])
    xf[..., 1::2, 1::2] = 0.25 * (
        xc[..., :-1, :-1] + xc[..., :-1, 1:] + xc[..., 1:, :-1] + xc[..., 1:, 1:]
    )
    return xf


def restrict(rf, nyc, nxc):
    """Exact adjoint of `prolong`: (..., ny, nx) -> (..., nyc, nxc)."""
    ny, nx = rf.shape[-2:]
    fp = F.pad(rf, (1, 1, 1, 1))

    def f(dj, di):
        return fp[..., 1 + dj : 1 + dj + ny : 2, 1 + di : 1 + di + nx : 2]

    return (
        f(0, 0)
        + 0.5 * (f(0, 1) + f(0, -1) + f(1, 0) + f(-1, 0))
        + 0.25 * (f(1, 1) + f(1, -1) + f(-1, 1) + f(-1, -1))
    )


_W1D = {-1: 0.5, 0: 1.0, 1: 0.5}  # hat weights of the bilinear prolongation


def galerkin_coarse_stencil(op: StencilOperator) -> StencilOperator:
    """A_c = P^T A P in stencil form, in closed form.

    Bilinear prolongation has separable hat weights w(-1, 0, 1) = (1/2, 1,
    1/2) per dimension, so the Galerkin entry coupling coarse nodes (J, I)
    and (J+dJ, I+dI) is a finite sum over fine offsets (a, b) around
    (2J, 2I) and (c, d) around the neighbour:

        Wc[J,I,dJ,dI] = sum_{a,c: |2dJ+c-a|<=1} sum_{b,d: |2dI+d-b|<=1}
            w(a) w(c) w(b) w(d) * W[2J+a, 2I+b, 2dJ+c-a, 2dI+d-b]

    169 strided-slice multiply-adds on coarse-sized planes, in the JAX
    package's order, on the planes' device. Out-of-grid fine entries are
    zero (zero padding), matching the fine operator's zero Dirichlet
    exterior.
    """
    planes = op.planes
    ny, nx = op.grid_shape
    nyc, nxc = (ny + 1) // 2, (nx + 1) // 2
    pp = F.pad(planes, (1, 1, 1, 1))  # (4, 3, 3, ny+2, nx+2)
    out = planes.new_empty((4, 3, 3, nyc, nxc))
    for dJ in (-1, 0, 1):
        y_terms = [
            (a, c, _W1D[a] * _W1D[c]) for a in (-1, 0, 1) for c in (-1, 0, 1) if abs(2 * dJ + c - a) <= 1
        ]
        for dI in (-1, 0, 1):
            x_terms = [
                (b, d, _W1D[b] * _W1D[d]) for b in (-1, 0, 1) for d in (-1, 0, 1) if abs(2 * dI + d - b) <= 1
            ]
            acc = planes.new_zeros((4, nyc, nxc))
            for a, c, wy in y_terms:
                sj = 2 * dJ + c - a
                rows = slice(1 + a, 1 + a + 2 * nyc - 1, 2)
                for b, d, wx in x_terms:
                    si = 2 * dI + d - b
                    cols = slice(1 + b, 1 + b + 2 * nxc - 1, 2)
                    acc = acc + (wy * wx) * pp[:, sj + 1, si + 1, rows, cols]
            out[:, dJ + 1, dI + 1] = acc  # in place: out is fresh, filled once per (dJ, dI)
    return StencilOperator(out)


def galerkin_coarse_stencil_probe(op: StencilOperator) -> StencilOperator:
    """A_c = P^T A P in stencil form by comb probing (validation path).

    The coarse stencil reaches one coarse node (two fine nodes plus P's
    reach of one: three fine nodes, less than the comb spacing of four),
    so spacing-4 delta combs isolate single columns of A_c exactly: 32
    fine-grid matvecs.
    """
    ny, nx = op.grid_shape
    nyc, nxc = (ny + 1) // 2, (nx + 1) // 2
    dtype, dev = op.planes.dtype, op.planes.device
    Wc = torch.zeros((nyc, nxc, 3, 3, 2, 2), dtype=dtype, device=dev)
    for pj in range(4):
        for pi in range(4):
            for d in range(2):
                xc = torch.zeros((2, nyc, nxc), dtype=dtype, device=dev)
                xc[d, pj::4, pi::4] = 1.0
                rc = restrict(op.matvec_field(prolong(xc, ny, nx)), nyc, nxc)
                rc_nodes = rc.permute(1, 2, 0)  # (nyc, nxc, 2)
                for dJ in (-1, 0, 1):
                    for dI in (-1, 0, 1):
                        sj, si = (pj + dJ) % 4, (pi + dI) % 4
                        # in place: Wc is a fresh accumulator owned here
                        Wc[sj::4, si::4, 1 - dJ, 1 - dI, :, d] = rc_nodes[sj::4, si::4, :]
    return StencilOperator.from_block(Wc)


@dataclasses.dataclass(frozen=True)
class MGLevel:
    A: StencilOperator
    smoother: Any  # PC applied as the pre-smoother
    post_smoother: Any = None  # None: the same as `smoother`

    @property
    def post(self):
        return self.smoother if self.post_smoother is None else self.post_smoother


@dataclasses.dataclass(frozen=True)
class MGPC:
    """V(1,1)-cycle geometric multigrid as a (linear) PC; `cycles` V-cycles
    per application, each on the residual of the last. Takes a dof-major
    (2, ny, nx) field or the natural flat vector."""

    levels: Tuple[MGLevel, ...]
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator, natural ordering
    cycles: int = 1

    def __call__(self, r):
        flat = r.ndim == 1
        if not self.levels:  # a grid too small to coarsen: the dense solve is exact
            return self.coarse_inv @ r if flat else self._coarse_solve(r)
        if flat:
            r = flat_to_field(r, *self.levels[0].A.grid_shape)
        z = torch.zeros_like(r)
        for _ in range(self.cycles):
            z = z + self._vcycle(0, r - self.levels[0].A.matvec_field(z))
        return field_to_flat(z) if flat else z

    def _coarse_solve(self, r):
        """The coarsest solve: the dense inverse is in the natural ordering,
        and the system is tiny, so a dense product solves it."""
        ny, nx = r.shape[-2:]
        return flat_to_field(self.coarse_inv @ field_to_flat(r), ny, nx)

    def _vcycle(self, k, r):
        if k == len(self.levels):
            return self._coarse_solve(r)
        lvl = self.levels[k]
        z = lvl.smoother(r)  # pre-smooth from a zero initial guess
        res = r - lvl.A.matvec_field(z)
        ny, nx = r.shape[-2:]
        zc = self._vcycle(k + 1, restrict(res, (ny + 1) // 2, (nx + 1) // 2))
        z = z + prolong(zc, ny, nx)
        return z + lvl.post(r - lvl.A.matvec_field(z))  # post-smooth


@dataclasses.dataclass(frozen=True)
class _DampedPBJacobi:
    """omega times the point-block Jacobi solve: the "jacobi" smoother."""

    inv_blocks: torch.Tensor  # (ny, nx, 2, 2)
    omega: float = 0.8

    def __call__(self, r):
        return self.omega * precond.block_apply_field(self.inv_blocks, r)


_SMOOTHERS = ("sor", "sor-fb", "chebyshev", "jacobi")
# the dense coarse solve's cap: above it a dense inverse is gigabytes
COARSE_DOF_CAP = 8192


def _smoothers(op: StencilOperator, smoother):
    """(pre, post) smoothers of one level; post None means the same."""
    if smoother == "sor":
        return precond.sor(op, omega=1.0, sweeps=1), None
    if smoother == "sor-fb":
        # forward before, backward after: the V-cycle is symmetric as a
        # whole at half the smoothing matvecs of symmetric SOR at both ends
        return (precond.sor(op, omega=1.0, sweeps=1, order="forward"),
                precond.sor(op, omega=1.0, sweeps=1, order="backward"))
    if smoother == "chebyshev":
        # Chebyshev smoothing targets the upper spectrum [lmax/4, lmax] of
        # the Jacobi-preconditioned operator (PETSc PCMG's default
        # smoother); D^-1 A reaches about 2, so lmax is estimated per level
        Mj = precond.jacobi(op)
        tmpl = torch.ones((2, *op.grid_shape), dtype=op.planes.dtype, device=op.planes.device)
        lmax = 1.1 * precond.estimate_lmax(op, Mj, template=tmpl)
        return precond.chebyshev_pc(op, inner=Mj, lmin=lmax / 4.0, lmax=lmax, iters=3), None
    if smoother == "jacobi":
        return _DampedPBJacobi(precond.pbjacobi(op).inv_blocks, 0.8), None
    raise ValueError(f"mg smoother {smoother!r}: use one of {_SMOOTHERS}")


def mg_pc(A: StencilOperator, opts=None, max_levels=10, coarse_size=5, smoother="sor", cycles=1) -> MGPC:
    """Build the hierarchy on A's device: Galerkin coarsening while both
    node counts are odd and above `coarse_size`, up to `max_levels`
    levels (the coarsest included), then a dense inverse of the coarsest
    operator on the host. Options: -pc_mg_levels, -pc_mg_smoother
    {sor,sor-fb,chebyshev,jacobi}, -pc_mg_cycles."""
    if opts is not None:
        max_levels = opts.get_int("pc_mg_levels", max_levels)
        smoother = opts.get_str("pc_mg_smoother", smoother)
        cycles = opts.get_int("pc_mg_cycles", cycles)
    if smoother not in _SMOOTHERS:
        raise ValueError(f"mg smoother {smoother!r}: use one of {_SMOOTHERS}")
    levels = []
    op = A
    while len(levels) < max_levels - 1:
        ny, nx = op.grid_shape
        if ny <= coarse_size or nx <= coarse_size:
            break
        if (ny - 1) % 2 or (nx - 1) % 2:
            break  # not coarsenable further (needs odd node counts)
        levels.append(MGLevel(op, *_smoothers(op, smoother)))
        op = galerkin_coarse_stencil(op)
    cny, cnx = op.grid_shape
    if cny * cnx * 2 > COARSE_DOF_CAP:
        raise ValueError(
            f"mg_pc: coarsest level is {cny}x{cnx} nodes "
            f"({cny * cnx * 2} dofs) — too large for a dense coarse solve. "
            "Grids coarsen only while node counts are odd (2^k+1 nodes = "
            "2^k elements per axis coarsen fully); choose such a grid or "
            "raise max_levels."
        )
    dense = _stencil_to_dense_host(op.W.detach().cpu().numpy())
    coarse_inv = torch.tensor(np.linalg.inv(dense), device=op.planes.device)
    return MGPC(tuple(levels), coarse_inv, cycles)


def _stencil_to_dense_host(W):
    """Dense natural-ordering matrix of a block-layout (ny, nx, 3, 3, 2, 2)
    stencil, in numpy: the coarsest level's assembly."""
    ny, nx = W.shape[:2]
    n = ny * nx * 2
    dense = np.zeros((n, n), W.dtype)
    for dj in range(3):
        for di in range(3):
            blk = W[:, :, dj, di]  # (ny, nx, 2, 2)
            jlo, jhi = max(0, 1 - dj), ny - max(0, dj - 1)
            ilo, ihi = max(0, 1 - di), nx - max(0, di - 1)
            for j in range(jlo, jhi):
                for i in range(ilo, ihi):
                    r = (j * nx + i) * 2
                    c = ((j + dj - 1) * nx + (i + di - 1)) * 2
                    dense[r : r + 2, c : c + 2] += blk[j, i]
    return dense
