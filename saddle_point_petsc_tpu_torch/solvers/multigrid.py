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
- Coarsest level: a dense inverse formed at set-up where the operator
  lives (the dense matrix in one scatter; on a CUDA device an LU on the
  card, on the CPU numpy's LAPACK), applied with `torch.matmul`.

Every level's stencil matvec, in the residuals and in the smoothers, goes
through `StencilOperator`: kernel B1 on a CUDA device. The V-cycle is
linear and symmetric (for the symmetric smoothers), so it is a valid
CG/MINRES preconditioner. Grids coarsen only while the node counts are
odd: 2^k + 1 nodes per side coarsen all the way.

One `cycle` (and `v_cycles`, -pc_mg_cycles of them) serves these
hierarchies and solvers/amg.py's. A level's transfers read their input's
one-node ring through its operator's `pad`.

The distributed hierarchy (`DistMGPC`, `mg_pc_dist`) is the serial one on
the active (unpadded) region of a `DistStencilOperator`, its levels split
over the ranks: a coarse node J lives on the rank that owns fine node 2J,
so every rank of a mesh row holds the same coarse rows and every rank of
a mesh column the same coarse columns (an unequal tiling whose faces
still match across each exchange). Restriction, prolongation and the
Galerkin product each read a one-node ring of their input from the
neighbours (one single-phase halo exchange); the smoothers run on the
level's distributed operator. Once some rank would hold fewer than two
nodes on an axis, or the level is the coarsest, the level is gathered to
every rank and the V-cycle finishes there on the serial hierarchy of the
gathered grid, every rank holding the same dense inverse. Padding nodes
are identity rows: z = r there. A world of one runs the same code,
exchanging with no peer, and gives the serial `mg_pc`'s bits.

Spans (utils/monitor.py, recorded while a torch profiler runs): an apply
runs under `MGApply`; in it, level k's smoothing (pre and post) under
`MGSmooth Lk`, its residuals under `MGResid Lk`, restriction under
`MGRestrict Lk`, prolongation under `MGInterp Lk`, the dense coarse solve
under `MGCoarseSolve`, and the distributed hierarchy's gather to every
rank and scatter back under `MGGather` and `MGScatter`. Set-up runs level
k under `MGSetUp Lk` (smoothers, with their eigen-estimates, and the
Galerkin product) and the coarsest level's dense matrix and its inverse
under `MGCoarseSetUp`. Levels are numbered from the finest, 0, through
the split levels and then the replicated tail; the names are built once,
at set-up (`LevelSpans`).
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
from saddle_point_petsc_tpu_torch.parallel.dist import DistStencilOperator
from saddle_point_petsc_tpu_torch.parallel.mesh import all_gather_tiles
from saddle_point_petsc_tpu_torch.solvers import precond
from saddle_point_petsc_tpu_torch.utils.monitor import count, span


def _prolong_window(xcp, ey, ex, ny, nx):
    """Bilinear interpolation onto an (ny, nx) window of the fine grid from
    the coarse nodes around it: xcp holds the window's coarse nodes with a
    one-node ring, (ey, ex) is the parity of the window's first fine node
    (even fine node 2J sits on coarse node J)."""

    def parents(e, n):
        # padded-coarse slices: the even nodes' own coarse node, and the
        # two coarse neighbours of the odd ones
        ne, no = (n - e + 1) // 2, (n - (1 - e) + 1) // 2
        return slice(1, 1 + ne), slice(1 - e, 1 - e + no), slice(2 - e, 2 - e + no)

    (Ey, Ay, By), (Ex, Ax, Bx) = parents(ey, ny), parents(ex, nx)
    oy, ox = 1 - ey, 1 - ex
    xf = xcp.new_zeros(xcp.shape[:-2] + (ny, nx))
    # in place: xf is a fresh tensor owned by this function
    xf[..., ey::2, ex::2] = xcp[..., Ey, Ex]
    xf[..., ey::2, ox::2] = 0.5 * (xcp[..., Ey, Ax] + xcp[..., Ey, Bx])
    xf[..., oy::2, ex::2] = 0.5 * (xcp[..., Ay, Ex] + xcp[..., By, Ex])
    xf[..., oy::2, ox::2] = 0.25 * (
        xcp[..., Ay, Ax] + xcp[..., Ay, Bx] + xcp[..., By, Ax] + xcp[..., By, Bx]
    )
    return xf


def _restrict_window(fp, ey, ex, nyc, nxc):
    """P^T on an (nyc, nxc) window of the coarse grid from the fine nodes
    around it: fp holds the window's fine nodes with a one-node ring, its
    first coarse node's fine node 2J at row ey, column ex of the window."""

    def f(dj, di):
        return fp[..., 1 + ey + dj : ey + dj + 2 * nyc : 2, 1 + ex + di : ex + di + 2 * nxc : 2]

    return (
        f(0, 0)
        + 0.5 * (f(0, 1) + f(0, -1) + f(1, 0) + f(-1, 0))
        + 0.25 * (f(1, 1) + f(1, -1) + f(-1, 1) + f(-1, -1))
    )


def prolong(xc, ny, nx):
    """Bilinear interpolation on the last two (spatial) dims:
    (..., nyc, nxc) -> (..., ny, nx) with ny = 2*nyc-1, nx = 2*nxc-1
    (nested node grids). Works on dof-major (2, nyc, nxc) fields."""
    return _prolong_window(F.pad(xc, (1, 1, 1, 1)), 0, 0, ny, nx)


def restrict(rf, nyc, nxc):
    """Exact adjoint of `prolong`: (..., ny, nx) -> (..., nyc, nxc)."""
    return _restrict_window(F.pad(rf, (1, 1, 1, 1)), 0, 0, nyc, nxc)


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
    ny, nx = op.grid_shape
    return StencilOperator(_galerkin_window(op.pad(op.planes), 0, 0, (ny + 1) // 2, (nx + 1) // 2))


def _galerkin_window(pp, ey, ex, nyc, nxc):
    """The Galerkin planes of an (nyc, nxc) window of the coarse grid from
    the fine planes around it: pp holds the window's fine planes with a
    one-node ring (4, 3, 3, ., .), the first coarse node's fine node 2J at
    row ey, column ex of the window."""
    out = pp.new_empty((4, 3, 3, nyc, nxc))
    for dJ in (-1, 0, 1):
        y_terms = [
            (a, c, _W1D[a] * _W1D[c]) for a in (-1, 0, 1) for c in (-1, 0, 1) if abs(2 * dJ + c - a) <= 1
        ]
        for dI in (-1, 0, 1):
            x_terms = [
                (b, d, _W1D[b] * _W1D[d]) for b in (-1, 0, 1) for d in (-1, 0, 1) if abs(2 * dI + d - b) <= 1
            ]
            acc = pp.new_zeros((4, nyc, nxc))
            for a, c, wy in y_terms:
                sj = 2 * dJ + c - a
                rows = slice(1 + ey + a, ey + a + 2 * nyc, 2)
                for b, d, wx in x_terms:
                    si = 2 * dI + d - b
                    cols = slice(1 + ex + b, ex + b + 2 * nxc, 2)
                    acc = acc + (wy * wx) * pp[:, sj + 1, si + 1, rows, cols]
            out[:, dJ + 1, dI + 1] = acc  # in place: out is fresh, filled once per (dJ, dI)
    return out


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
class LevelSpans:
    """The span names of level k, built once at set-up."""

    smooth: str
    resid: str
    restrict: str
    interp: str
    setup: str

    @staticmethod
    def of(k):
        return LevelSpans(*(f"{event} L{k}" for event in ("MGSmooth", "MGResid", "MGRestrict", "MGInterp", "MGSetUp")))


@dataclasses.dataclass(frozen=True)
class MGLevel:
    A: Any  # StencilOperator, or a DistStencilOperator on a split level
    smoother: Any  # PC applied as the pre-smoother
    post_smoother: Any = None  # None: the same as `smoother`
    spans: LevelSpans = LevelSpans.of(0)

    @property
    def post(self):
        return self.smoother if self.post_smoother is None else self.post_smoother

    def restrict(self, res):
        """P^T res on this level's grid, or on this rank's patch of it."""
        (j0, i0), (mj, mi) = self.A.origin, res.shape[-2:]
        ey, ex = j0 % 2, i0 % 2
        return _restrict_window(self.A.pad(res), ey, ex, (mj - ey + 1) // 2, (mi - ex + 1) // 2)

    def prolong(self, zc):
        """P zc on this level's grid, or on this rank's patch of it."""
        (j0, i0), (mj, mi) = self.A.origin, self.A.planes.shape[-2:]
        return _prolong_window(self.A.pad(zc), j0 % 2, i0 % 2, mj, mi)


def cycle(levels, coarse, r, k=0, w=False):
    """One V-cycle (W-cycle if `w`) on level k's r from a zero guess;
    `coarse(r)` solves below the last level. A level offers `A`,
    `smoother`, `post`, `restrict`, `prolong` and `spans`."""
    if k == len(levels):
        return coarse(r)
    lvl = levels[k]
    names = lvl.spans
    with span(names.smooth):
        z = lvl.smoother(r)
    with span(names.resid):
        res = r - lvl.A(z)
    with span(names.restrict):
        rc = lvl.restrict(res)
    zc = cycle(levels, coarse, rc, k + 1, w)
    if w and k + 1 < len(levels):  # again on the new residual, but not on the exact coarsest
        zc = zc + cycle(levels, coarse, rc - levels[k + 1].A(zc), k + 1, w)
    with span(names.interp):
        z = z + lvl.prolong(zc)
    with span(names.resid):
        res = r - lvl.A(z)
    with span(names.smooth):
        return z + lvl.post(res)


def v_cycles(levels, coarse, r, n):
    """n V-cycles from a zero guess, each on the residual of the last
    (-pc_mg_cycles of -pc_type mg); with no level, the coarse solve."""
    if not levels:
        return coarse(r)
    top = levels[0]
    z = torch.zeros_like(r)
    for _ in range(n):
        with span(top.spans.resid):
            res = r - top.A(z)
        z = z + cycle(levels, coarse, res)
    return z


@dataclasses.dataclass(frozen=True)
class MGPC:
    """V(1,1)-cycle geometric multigrid as a (linear) PC; `cycles` V-cycles
    per application, each on the residual of the last. Takes a dof-major
    (2, ny, nx) field or the natural flat vector."""

    levels: Tuple[MGLevel, ...]
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator, natural ordering
    cycles: int = 1

    def __call__(self, r):
        with span("MGApply"):
            if r.ndim == 1 and self.levels:
                return field_to_flat(self.apply_field(flat_to_field(r, *self.levels[0].A.grid_shape)))
            return self.apply_field(r)

    def apply_field(self, r):
        """The PC on a (2, ny, nx) field, outside `MGApply`."""
        return v_cycles(self.levels, self._coarse, r, self.cycles)

    def vcycle(self, r):
        """One V-cycle on a (2, ny, nx) field from a zero initial guess."""
        return cycle(self.levels, self._coarse, r)

    def _coarse(self, r):
        """The coarsest solve: the dense inverse is in the natural ordering,
        and the system is tiny, so a dense product solves it."""
        with span("MGCoarseSolve"):
            if r.ndim == 1:
                return self.coarse_inv @ r
            ny, nx = r.shape[-2:]
            return flat_to_field(self.coarse_inv @ field_to_flat(r), ny, nx)


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
        # the start vector is drawn over the level's global grid
        lmax = 1.1 * precond.estimate_lmax(op, Mj, template=torch.ones_like(op.diagonal()))
        return precond.chebyshev_pc(op, inner=Mj, lmin=lmax / 4.0, lmax=lmax, iters=3), None
    if smoother == "jacobi":
        return _DampedPBJacobi(precond.pbjacobi(op).inv_blocks, 0.8), None
    raise ValueError(f"mg smoother {smoother!r}: use one of {_SMOOTHERS}")


def _mg_options(opts, max_levels, smoother, cycles):
    if opts is not None:
        max_levels = opts.get_int("pc_mg_levels", max_levels)
        smoother = opts.get_str("pc_mg_smoother", smoother)
        cycles = opts.get_int("pc_mg_cycles", cycles)
    if smoother not in _SMOOTHERS:
        raise ValueError(f"mg smoother {smoother!r}: use one of {_SMOOTHERS}")
    return max_levels, smoother, cycles


def _coarsens(shape, n_levels, max_levels, coarse_size):
    """Whether a level of `shape` nodes, below n_levels others, is
    smoothed and coarsened: room for another level, both node counts
    above coarse_size and odd."""
    ny, nx = shape
    return n_levels < max_levels - 1 and ny > coarse_size and nx > coarse_size and ny % 2 == 1 and nx % 2 == 1


def _check_coarsest(cny, cnx):
    if cny * cnx * 2 > COARSE_DOF_CAP:
        raise ValueError(
            f"mg_pc: coarsest level is {cny}x{cnx} nodes "
            f"({cny * cnx * 2} dofs) — too large for a dense coarse solve. "
            "Grids coarsen only while node counts are odd (2^k+1 nodes = "
            "2^k elements per axis coarsen fully); choose such a grid or "
            "raise max_levels."
        )


def mg_pc(A: StencilOperator, opts=None, max_levels=10, coarse_size=5, smoother="sor", cycles=1,
          level0=0) -> MGPC:
    """Build the hierarchy on A's device: Galerkin coarsening while both
    node counts are odd and above `coarse_size`, up to `max_levels`
    levels (the coarsest included), then a dense inverse of the coarsest
    operator, formed afresh on A's device (`_dense_inverse`: an LU on the
    card on a CUDA device, numpy's on the CPU). Options: -pc_mg_levels,
    -pc_mg_smoother {sor,sor-fb,chebyshev,jacobi}, -pc_mg_cycles.
    `level0` numbers the first level in the span names (a distributed
    hierarchy's tail continues its count)."""
    max_levels, smoother, cycles = _mg_options(opts, max_levels, smoother, cycles)
    levels = []
    op = A
    while _coarsens(op.grid_shape, len(levels), max_levels, coarse_size):
        names = LevelSpans.of(level0 + len(levels))
        with span(names.setup):
            levels.append(MGLevel(op, *_smoothers(op, smoother), spans=names))
            op = galerkin_coarse_stencil(op)
    _check_coarsest(*op.grid_shape)
    with span("MGCoarseSetUp"):
        coarse_inv = _dense_inverse(_stencil_to_dense(op.planes.detach()))
    return MGPC(tuple(levels), coarse_inv, cycles)


def _stencil_to_dense(planes):
    """Dense natural-ordering matrix of a (4, 3, 3, ny, nx) stencil, on the
    planes' device: one scatter-add into zeros. Entry (2a + b, dj, di, j, i)
    goes to row (j*nx + i)*2 + a, column ((j+dj-1)*nx + i+di-1)*2 + b; each
    (row node, offset) names its own column node, so every entry is added
    once to a zero, the bits of the JAX package's loop over nodes. Entries
    whose column node is off the grid go to one spare slot past the matrix."""
    ny, nx = planes.shape[-2:]
    n = ny * nx * 2

    def axis(k, dim):  # arange(k) along dim of the planes' (2, 2, 3, 3, ny, nx) view
        shape = [1] * 6
        shape[dim] = k
        return torch.arange(k, device=planes.device).view(shape)

    j, i = axis(ny, 4), axis(nx, 5)
    cj, ci = j + axis(3, 2) - 1, i + axis(3, 3) - 1
    on = (cj >= 0) & (cj < ny) & (ci >= 0) & (ci < nx)
    at = ((j * nx + i) * 2 + axis(2, 0)) * n + (cj * nx + ci) * 2 + axis(2, 1)
    flat = planes.new_zeros(n * n + 1)
    flat.index_add_(0, torch.where(on, at, n * n).reshape(-1), planes.reshape(-1))
    return flat[:-1].view(n, n)


def _dense_inverse(dense):
    """The coarsest level's inverse, where `dense` lives: on a CUDA device a
    dense LU on the card (cuSOLVER, in dense's dtype; counted in
    `MGCoarse.device`), whose status word is the one read back; on the CPU
    numpy's LAPACK, the JAX package's bits. A singular operator raises
    numpy's LinAlgError on both."""
    if not dense.is_cuda:
        return torch.from_numpy(np.linalg.inv(dense.numpy()))
    inv, info = torch.linalg.inv_ex(dense)
    if info.item():
        raise np.linalg.LinAlgError("Singular matrix")
    count("MGCoarse.device")
    return inv.contiguous()  # row-major, as numpy's: the coarse solve's product keeps its kernel


# ---------------------------------------------------------------------------
# The distributed hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Tiling:
    """How a level's node grid lies over the mesh: the global row range
    (lo, hi) of each mesh row and the column range of each mesh column."""

    rows: tuple
    cols: tuple

    @staticmethod
    def of(ny, nx, my, mx, mesh):
        """Equal patches of (my, mx) nodes, cut to the first (ny, nx)."""
        return _Tiling(tuple((min(j * my, ny), min((j + 1) * my, ny)) for j in range(mesh.py)),
                       tuple((min(i * mx, nx), min((i + 1) * mx, nx)) for i in range(mesh.px)))

    @property
    def shape(self):
        return (self.rows[-1][1], self.cols[-1][1])

    def patch(self, mesh):
        """This rank's ((j0, j1), (i0, i1))."""
        return self.rows[mesh.pj], self.cols[mesh.pi]

    def coarse(self):
        """The coarse level's tiling: coarse node J goes with fine node 2J."""

        def halve(ranges):
            return tuple((-(-lo // 2), -(-hi // 2)) for lo, hi in ranges)

        return _Tiling(halve(self.rows), halve(self.cols))

    def min_extent(self):
        return min(hi - lo for lo, hi in self.rows + self.cols)


def _level_operator(planes, tiling, mesh):
    ((j0, _), (i0, _)) = tiling.patch(mesh)
    return DistStencilOperator(planes, mesh, tiling=((j0, i0), tiling.shape))


def _dist_galerkin(A: DistStencilOperator, coarse: _Tiling):
    """The coarse level's operator on this rank's coarse patch: the Galerkin
    planes from the fine planes and their ring (one exchange of the 36
    planes)."""
    (j0, i0), ((J0, J1), (I0, I1)) = A.origin, coarse.patch(A.mesh)
    pp = A.pad(A.planes)
    return _level_operator(_galerkin_window(pp, 2 * J0 - j0, 2 * I0 - i0, J1 - J0, I1 - I0), coarse, A.mesh)


@dataclasses.dataclass(frozen=True)
class DistMGPC:
    """V-cycle geometric multigrid on a DistStencilOperator's patches.

    `levels` are split over the ranks (their operators on unequal
    tilings); `tail` is the serial hierarchy of the first level gathered
    to every rank (`tiling` says how that level lies over the mesh), so
    that the coarse end of the cycle runs replicated. Takes and returns
    this rank's (2, my, mx) patch; nodes outside the `active` (mj, mi)
    corner of the patch are padding rows, z = r there. Symmetric and
    linear for the symmetric smoothers, like `MGPC`."""

    levels: Tuple[MGLevel, ...]
    tail: MGPC
    tiling: _Tiling
    active: tuple
    mesh: Any
    cycles: int = 1

    def __call__(self, r):
        with span("MGApply"):
            mj, mi = self.active
            z = v_cycles(self.levels, self._coarse, r[:, :mj, :mi], self.cycles)
            if (mj, mi) == tuple(r.shape[-2:]):
                return z
            out = r.clone()
            out[:, :mj, :mi] = z  # in place: out is the copy of r made above
            return out

    def _coarse(self, r):
        """This rank's patch of the tail's V-cycle (with no split level, its
        whole apply) on the level gathered to every rank."""
        with span("MGGather"):
            g = all_gather_tiles(r.contiguous(), self.mesh, self.tiling.rows, self.tiling.cols)
        z = self.tail.vcycle(g) if self.levels else self.tail.apply_field(g)
        (j0, j1), (i0, i1) = self.tiling.patch(self.mesh)
        with span("MGScatter"):
            return z[..., j0:j1, i0:i1].contiguous()


def mg_pc_dist(A: DistStencilOperator, opts=None, max_levels=10, coarse_size=5, smoother="sor",
               cycles=1) -> DistMGPC:
    """Multigrid for a DistStencilOperator: the serial `mg_pc` hierarchy of
    its active region, with the same options, levels, smoothers and dense
    cap (its ValueError is raised before anything is gathered). Each
    level stays split over the ranks while every rank holds at least two
    nodes on each axis and it is not the coarsest; from the first level
    that is not, the hierarchy is built serially on every rank from that
    level's gathered planes. Collective: every rank calls it."""
    max_levels, smoother, cycles = _mg_options(opts, max_levels, smoother, cycles)
    mesh = A.mesh
    nyt, nxt = A.active_shape or A.grid_shape
    shape, n_levels = (nyt, nxt), 0
    while _coarsens(shape, n_levels, max_levels, coarse_size):
        shape, n_levels = ((shape[0] + 1) // 2, (shape[1] + 1) // 2), n_levels + 1
    _check_coarsest(*shape)

    tiling = _Tiling.of(nyt, nxt, *A.local_shape, mesh)
    (j0, j1), (i0, i1) = tiling.patch(mesh)
    active = (j1 - j0, i1 - i0)
    op = _level_operator(A.planes[..., : active[0], : active[1]].contiguous(), tiling, mesh)
    levels = []
    while len(levels) < n_levels and tiling.min_extent() >= 2:
        names = LevelSpans.of(len(levels))
        with span(names.setup):
            levels.append(MGLevel(op, *_smoothers(op, smoother), spans=names))
            coarse = tiling.coarse()
            op, tiling = _dist_galerkin(op, coarse), coarse
    with span("MGGather"):
        planes = all_gather_tiles(op.planes, mesh, tiling.rows, tiling.cols)
    tail = mg_pc(StencilOperator(planes), max_levels=max_levels - len(levels), coarse_size=coarse_size,
                 smoother=smoother, cycles=cycles, level0=len(levels))
    return DistMGPC(tuple(levels), tail, tiling, active, mesh, cycles)
