"""Distributed problems and operators over a process mesh (PyTorch twin of
`saddle_point_petsc_tpu.parallel.dist`).

A DMDA over torch.distributed: the global node grid is block-partitioned
over a `ProcessMesh`, one rank per patch, and every step is SPMD:

- assembly: each rank sums the element matrices, loads and constraint
  integrals of the elements whose lower-left node it owns into padded
  accumulators (on the card kernel FE, `ops.cuda.assembly.q1_assemble`;
  on the CPU its plain version, the batched products of models/fem.py)
  and folds the edge contributions onto its neighbours with `halo_add`
  (MatAssembly's stash-and-ship, DMLocalToGlobal with ADD_VALUES);
  neighbour masks come from `halo_exchange`.
- SpMV: the single-phase halo exchange posted first, kernel B1 on the
  local patch with zero ghosts while it is in flight, then four thin edge
  corrections (`_local_matvec`). SpMM (`matmat_field`): one exchange for
  all k fields, then B1's padded entry on each exchanged field (the JAX
  package's backend="pallas" form).
- reductions: every inner product sums the ranks' partial dots with one
  all_reduce (solvers/krylov.py, `distributed`); `DistSaddleOperator`
  sums its B u, and the Schur PC its B D^-1 B^T, the same way.

Grids that do not divide the mesh are padded with inactive nodes (identity
rows, zero right-hand side), harmless to Krylov and to iteration counts.
Element coordinates come from the same `torch.linspace` as the serial
assembly (models/fem.py), sliced to the rank's elements, so on the CPU a
world of one assembles the serial operator bit for bit; on the card
kernel FE sums in its own order, within rounding of the serial operator.

Spans (utils/monitor.py): `assemble_poisson_dist` and
`assemble_saddle_dist` run under `MatAssembly`; in it, on the card, the
kernel's launch under `FEAssemble`; on the CPU, the element matrices and
loads under `FEElementMatrices` and `FEElementRHS` (models/fem.py), their
sum into the stencil planes under `MatSetValues` and the constraint
integrals under `FEConstraints`; then the ghost folds under `HaloAdd` and
the Dirichlet mask and elimination under `FEBoundary`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from saddle_point_petsc_tpu_torch.models import fem
from saddle_point_petsc_tpu_torch.ops.cuda.assembly import q1_assemble
from saddle_point_petsc_tpu_torch.ops.cuda.spmv import stencil_spmv, stencil_spmv_padded
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
from saddle_point_petsc_tpu_torch.parallel.halo import (
    halo_add,
    halo_exchange,
    halo_exchange_1phase,
    halo_exchange_1phase_start,
)
from saddle_point_petsc_tpu_torch.parallel.mesh import ProcessMesh, gather_field
from saddle_point_petsc_tpu_torch.solvers import precond
from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator, constraint_apply, constraint_apply_t
from saddle_point_petsc_tpu_torch.utils.monitor import span

_NODE_OFF = ((0, 0), (1, 0), (1, 1), (0, 1))


@dataclasses.dataclass(frozen=True)
class DistGrid:
    """Static description of the partitioned node grid.

    nex/ney: global element counts; ny/nx: *padded* global node counts
    (divisible by the mesh); my/mx: per-rank patch node counts.
    """

    mesh: ProcessMesh
    nex: int
    ney: int
    ny: int
    nx: int

    @property
    def py(self):
        return self.mesh.py

    @property
    def px(self):
        return self.mesh.px

    @property
    def my(self):
        return self.ny // self.py

    @property
    def mx(self):
        return self.nx // self.px

    @property
    def jlo(self):
        """Global row of this rank's first node."""
        return self.mesh.pj * self.my

    @property
    def ilo(self):
        return self.mesh.pi * self.mx

    @staticmethod
    def create(nex, ney, mesh):
        ny = -(-(ney + 1) // mesh.py) * mesh.py
        nx = -(-(nex + 1) // mesh.px) * mesh.px
        return DistGrid(mesh, nex, ney, ny, nx)


def _edge_term(P, g):
    """sum over (d, k) of P[2c + d, k, i] * g[d, i + k]: one ghost line's
    contribution to the outputs beside it. P (4, 3, n) planes along the
    edge, g (2, n + 2) ghost line -> (2, n)."""
    n = P.shape[-1]
    G = torch.stack([g[:, k : k + n] for k in range(3)], dim=1)  # (2, 3, n)
    return (P.reshape(2, 2, 3, n) * G).sum(dim=(1, 2))


def _local_matvec(planes, x, mesh):
    """One rank's part of the distributed matvec.

    planes: local (4, 3, 3, my, mx); x: local (2, my, mx). The exchange is
    posted first, kernel B1 on the local patch with zero ghosts is
    launched before the wait, then the ghost contributions are added as
    four O(perimeter) edge corrections, each only where that neighbour
    exists:

        y = A_local x  +  sum_edges (ghost line -> adjacent row/column)
    """
    my, mx = x.shape[-2:]
    pending = halo_exchange_1phase_start(x, mesh)
    y = stencil_spmv(planes, x)
    g = pending.wait()

    def ghost_row(dj):
        # padded row j = -1 (dj = -1) or j = my (dj = +1), corners included
        parts = [g.get((dj, di)) for di in (-1, 0, 1)]
        if all(p is None for p in parts):
            return None
        return torch.cat([x.new_zeros((2, w)) if p is None else p[:, 0]
                          for p, w in zip(parts, (1, mx, 1))], dim=-1)

    # in place: y is the fresh output of B1
    lo, hi = ghost_row(-1), ghost_row(1)
    if lo is not None:
        y[:, 0, :] += _edge_term(planes[:, 0, :, 0, :], lo)
    if hi is not None:
        y[:, my - 1, :] += _edge_term(planes[:, 2, :, my - 1, :], hi)
    # ghost columns, corner rows zero (the row corrections counted them)
    for di, col in ((-1, 0), (1, mx - 1)):
        gc = g.get((0, di))
        if gc is not None:
            y[:, :, col] += _edge_term(planes[:, :, di + 1, :, col], F.pad(gc[..., 0], (1, 1)))
    return y


@dataclasses.dataclass(frozen=True)
class DistStencilOperator:
    """Stencil operator whose planes and vectors are this rank's patches of
    the global ones; its matvec exchanges halos with the neighbours.

    The patches tile the grid equally (the padded grid of `DistGrid`), or,
    given `tiling`, unequally: a multigrid level (solvers/multigrid.py),
    whose ranks in a mesh row share their rows and in a mesh column their
    columns, so that every face a rank sends is shaped like the one its
    neighbour sends back."""

    planes: torch.Tensor  # this rank's (4, 3, 3, my, mx)
    mesh: ProcessMesh
    # true (unpadded) node counts when the grid was padded to divide the
    # mesh; None = the whole grid is active
    active_shape: Any = None
    # ((j0, i0), (ny, nx)): this patch's global origin and the global grid
    # of an unequal tiling; None = equal patches, rank (pj, pi) at
    # (pj * my, pi * mx)
    tiling: Any = None
    # its vectors are this rank's patches (solvers/krylov.py)
    dist_leaves = ("patch",)

    @property
    def local_shape(self):
        return tuple(self.planes.shape[-2:])

    @property
    def grid_shape(self):
        """The global (ny, nx): padded, for equal patches."""
        if self.tiling is not None:
            return tuple(self.tiling[1])
        my, mx = self.local_shape
        return (my * self.mesh.py, mx * self.mesh.px)

    @property
    def origin(self):
        """The global (row, column) of this patch's first node."""
        if self.tiling is not None:
            return tuple(self.tiling[0])
        my, mx = self.local_shape
        return (self.mesh.pj * my, self.mesh.pi * mx)

    def local_patch(self, g):
        """This rank's (..., my, mx) view of a global array g (grid dims
        last, shaped `grid_shape`)."""
        (j0, i0), (my, mx) = self.origin, self.local_shape
        return g[..., j0 : j0 + my, i0 : i0 + mx]

    def global_like(self, t):
        """A template of t's dtype, on t's device, shaped like the global
        array whose patch t is: one element broadcast to that shape, as
        `ProcessMesh.global_like`."""
        return t.new_empty(()).expand(*t.shape[:-2], *self.grid_shape)

    @property
    def n(self):
        ny, nx = self.grid_shape
        return ny * nx * 2

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def nnz(self):
        """Stored stencil entries over all ranks."""
        return self.planes.numel() * self.mesh.size

    def pad(self, x):
        """(..., my, mx) patch -> (..., my+2, mx+2): x with its ring of the
        neighbours' nodes (one single-phase exchange), zero past the global
        boundary."""
        return halo_exchange_1phase(x, self.mesh)

    def matvec_field(self, x):
        """(2, my, mx) patch -> (2, my, mx) patch of A x."""
        return _local_matvec(self.planes, x.contiguous(), self.mesh)

    __call__ = matvec_field

    def matmat_field(self, X):
        """Distributed SpMM on a batch of k patches (k, 2, my, mx): ONE halo
        exchange ships the (k, 2)-deep edges of all k fields together, then
        B1's padded entry runs on each field."""
        Xp = halo_exchange_1phase(X.contiguous(), self.mesh)
        return torch.stack([stencil_spmv_padded(self.planes, xp) for xp in Xp])

    def diagonal(self):
        """diag(A) as a (2, my, mx) patch."""
        return torch.stack([self.planes[0, 1, 1], self.planes[3, 1, 1]])

    def diag_blocks(self):
        """Dense diagonal 2x2 blocks of the patch, (my, mx, 2, 2)."""
        d = self.planes[:, 1, 1]
        return d.reshape(2, 2, *d.shape[1:]).permute(2, 3, 0, 1)

    def as_local(self):
        """The gathered global operator on rank 0 (None on the others).
        Collective; tests and host post-processing only."""
        planes = gather_field(self.planes, self.mesh)
        return None if planes is None else StencilOperator(planes)


@dataclasses.dataclass(frozen=True)
class DistSaddleOperator(SaddleOperator):
    """KKT operator on (u, lam) with u a patch and lam replicated on every
    rank. B^T lam is local; B u is a local (m,) contraction summed over the
    ranks by one all_reduce."""

    A: DistStencilOperator
    Bf: torch.Tensor  # this rank's (m, 2, my, mx) patch of the rows
    # (u, lam): u this rank's patch, lam replicated (solvers/krylov.py)
    dist_leaves = ("patch", None)

    @property
    def mesh(self):
        return self.A.mesh

    def __call__(self, v):
        u, lam = v
        return (self.A(u) + constraint_apply_t(self.Bf, lam), self.mesh.all_reduce(constraint_apply(self.Bf, u)))


# ---------------------------------------------------------------------------
# Distributed assembly
# ---------------------------------------------------------------------------


def _local_axes(grid: DistGrid, dtype, device):
    """Node coordinates (xs, ys) of this rank's elements, those whose
    lower-left node it owns inside the true grid: ei + 1 and ej + 1 values
    of the serial assembly's `torch.linspace`."""
    ej = max(0, min(grid.my, grid.ney - grid.jlo))
    ei = max(0, min(grid.mx, grid.nex - grid.ilo))
    xs = torch.linspace(0.0, 1.0, grid.nex + 1, dtype=dtype, device=device)[grid.ilo : grid.ilo + ei + 1]
    ys = torch.linspace(0.0, 1.0, grid.ney + 1, dtype=dtype, device=device)[grid.jlo : grid.jlo + ej + 1]
    return xs, ys


def _local_elements(xs, ys):
    """Corner coordinates (ej, ei, 4, 2) of the elements spanned by the
    node coordinates xs and ys."""
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    return fem.element_corner_coords(torch.stack([X, Y], dim=-1))


def _scatter_nodes(ev, my, mx):
    """Fold per-element nodal values ev (ej, ei, 4, c) onto a padded
    (c, my + 2, mx + 2) patch, node by node in element order."""
    ej, ei = ev.shape[:2]
    out = ev.new_zeros((ev.shape[-1], my + 2, mx + 2))
    for a, (aj, ai) in enumerate(_NODE_OFF):
        # in place: out is the fresh accumulator made above
        out[:, 1 + aj : 1 + aj + ej, 1 + ai : 1 + ai + ei] += ev[:, :, a].permute(2, 0, 1)
    return out


def _planes_plain(corners, my, mx):
    ej, ei = corners.shape[:2]
    kb = fem.element_stiffness(corners).reshape(ej, ei, 4, 2, 4, 2)
    with span("MatSetValues"):
        Wp = kb.new_zeros((4, 3, 3, my + 2, mx + 2))
        for a, (aj, ai) in enumerate(_NODE_OFF):
            for b, (bj, bi) in enumerate(_NODE_OFF):
                contrib = kb[:, :, a, :, b, :].permute(2, 3, 0, 1).reshape(4, ej, ei)
                # in place: Wp is the fresh accumulator made above
                Wp[:, bj - aj + 1, bi - ai + 1, 1 + aj : 1 + aj + ej, 1 + ai : 1 + ai + ei] += contrib
    return Wp


def _load_plain(corners, my, mx, body_force):
    ej, ei = corners.shape[:2]
    bf = fem.BODY_FORCES[body_force] if isinstance(body_force, str) else body_force
    return _scatter_nodes(fem.element_rhs(corners, bf).reshape(ej, ei, 4, 2), my, mx)


def _rows_plain(corners, my, mx):
    from saddle_point_petsc_tpu_torch.models.saddle import default_constraints

    with span("FEConstraints"):
        xi, w = fem.gauss_quadrature_q1(corners.dtype, corners.device)
        ni = fem.shape_q1(xi)
        _, det = fem.grad_shape_physical(fem.grad_shape_q1(xi), corners[..., None, :, :])
        xp = ni @ corners  # (ej, ei, gp, 2)
        rows = []
        for fn in default_constraints():
            wx, wy = fn(xp[..., 0], xp[..., 1])
            be = ni.transpose(0, 1) @ ((w * det)[..., None] * torch.stack([wx, wy], dim=-1))
            rows.append(_scatter_nodes(be, my, mx))
        return torch.stack(rows)


def _accumulators_plain(xs, ys, my, mx, body_force=None, planes=True, rows=False):
    """The plain version of kernel FE: the element matrices, loads and
    constraint integrals of every element as batched products
    (models/fem.py), then their sum onto the padded nodes, element corner
    by element corner. (Wp, load, Bp), each None where not asked for; runs
    on the inputs' device."""
    corners = _local_elements(xs, ys)
    return (_planes_plain(corners, my, mx) if planes else None,
            None if body_force is None else _load_plain(corners, my, mx, body_force),
            _rows_plain(corners, my, mx) if rows else None)


def _accumulators(grid: DistGrid, dtype, body_force=None, planes=True, rows=False):
    """This rank's padded accumulators (Wp (4, 3, 3, my + 2, mx + 2), load
    (2, ...), Bp (4, 2, ...)), each None where not asked for: on the card
    one launch of kernel FE, which computes a named body force itself (the
    load of a callable one comes from the batched products); on the CPU
    the plain version."""
    my, mx = grid.my, grid.mx
    xs, ys = _local_axes(grid, dtype, grid.mesh.device)
    if not xs.is_cuda:
        return _accumulators_plain(xs, ys, my, mx, body_force, planes, rows)
    named = body_force if body_force is None or isinstance(body_force, str) else None
    with span("FEAssemble"):
        Wp, load, Bp = q1_assemble(xs, ys, my, mx, named, planes, rows)
    if named is None and body_force is not None:
        load = _load_plain(_local_elements(xs, ys), my, mx, body_force)
    return Wp, load, Bp


def assemble_poisson_dist(grid: DistGrid, dtype=torch.float64, body_force="constant"):
    """Distributed assembly of the boundary-eliminated vector-Poisson
    system on the mesh's device: per-rank element batches, `halo_add`
    ghost accumulation, symmetric elimination with neighbour masks.
    Returns (A: DistStencilOperator, f, mask), each this rank's patch."""
    with span("MatAssembly"):
        return _assemble(grid, dtype, body_force, constraints=False)[:3]


def _assemble(grid: DistGrid, dtype, body_force, constraints):
    """(A, f, mask, Bf): Bf the constraint rows, or None unless
    `constraints`."""
    mesh, my, mx = grid.mesh, grid.my, grid.mx
    dev = mesh.device
    Wp, load, Bp = _accumulators(grid, dtype, body_force, rows=constraints)
    W = halo_add(Wp, mesh)
    del Wp
    f = halo_add(load, mesh)
    with span("FEBoundary"):
        # masks: the Dirichlet boundary of the true grid, plus the padding nodes
        nyn, nxn = grid.ney + 1, grid.nex + 1
        gj = grid.jlo + torch.arange(my, device=dev)[:, None]
        gi = grid.ilo + torch.arange(mx, device=dev)[None, :]
        inactive = (gj >= nyn) | (gi >= nxn)
        mask = ((gi == 0) | (gi == nxn - 1) | (gj == 0) | (gj == nyn - 1)) | inactive
        # symmetric elimination, with the neighbours' masks from the exchange
        maskp = halo_exchange(mask.to(dtype), mesh) > 0.5
        W = torch.where(mask, 0.0, W)
        for dj in range(3):
            for di in range(3):
                # in place: W is the fresh tensor made by torch.where above
                W[:, dj, di] *= torch.where(maskp[dj : dj + my, di : di + mx], 0.0, 1.0).to(dtype)
        W[0, 1, 1] = torch.where(mask, 1.0, W[0, 1, 1])
        W[3, 1, 1] = torch.where(mask, 1.0, W[3, 1, 1])
        f = torch.where(mask, 0.0, f)
    A = DistStencilOperator(W.contiguous(), mesh, active_shape=(nyn, nxn))
    Bf = None if Bp is None else _constraint_rows(Bp, mask, mesh)
    return A, f.contiguous(), mask, Bf


def _constraint_rows(Bp, mask, mesh):
    """The padded constraint accumulators (4, 2, my + 2, mx + 2) folded
    onto their owners, Dirichlet columns zeroed."""
    return torch.where(mask, 0.0, halo_add(Bp, mesh)).contiguous()


def assemble_constraints_dist(grid: DistGrid, mask, dtype=torch.float64):
    """Distributed constraint rows -> this rank's (4, 2, my, mx) patch: the
    functionals of models/saddle.py, assembled per rank with `halo_add`."""
    _, _, Bp = _accumulators(grid, dtype, planes=False, rows=True)
    return _constraint_rows(Bp, mask, grid.mesh)


def assemble_saddle_dist(grid: DistGrid, dtype=torch.float64, body_force="trig"):
    """Distributed KKT system: (K, (f, g), mask), with K's planes, Bf and f
    this rank's patches and g replicated (BASELINE configs 4-5)."""
    with span("MatAssembly"):
        A, f, mask, Bf = _assemble(grid, dtype, body_force, constraints=True)
        g = torch.zeros((Bf.shape[0],), dtype=dtype, device=grid.mesh.device)
        return DistSaddleOperator(A, Bf), (f, g), mask


def patch_truncate(A: DistStencilOperator) -> DistStencilOperator:
    """Zero every stencil entry that couples across a patch boundary: the
    block-diagonal operator over the patches underlying distributed
    block-Jacobi (PETSc's parallel PCBJACOBI, one block per rank)."""
    p = A.planes.clone()
    # in place: p is the copy made above. Entry (., dj, di, j, i) couples
    # node (j, i) to (j+dj-1, i+di-1); zero those reaching outside
    p[:, 0, :, 0, :] = 0.0
    p[:, 2, :, -1, :] = 0.0
    p[:, :, 0, :, 0] = 0.0
    p[:, :, 2, :, -1] = 0.0
    return dataclasses.replace(A, planes=p)


@dataclasses.dataclass(frozen=True)
class DistScalarStencilOp(precond.ScalarStencilOp):
    """A scalar 9-point stencil on this rank's patch: its ghost ring comes
    from one single-phase halo exchange of the (1, my, mx) field."""

    mesh: Any = None

    def pad(self, x):
        return halo_exchange_1phase(x[None].contiguous(), self.mesh)[0]


def dist_fieldsplit(A: DistStencilOperator, fs_type="additive") -> precond.FieldSplitPC:
    """Fieldsplit over the velocity components on the rank's patches: the
    Jacobi sub-PCs are pointwise and exchange nothing; the multiplicative
    form's coupling A10 z0 exchanges z0's ghost ring once."""
    pc = precond.fieldsplit(A, fs_type=fs_type)
    return dataclasses.replace(pc, A10=DistScalarStencilOp(pc.A10.Ws, A.mesh))


def dist_block_jacobi(A: DistStencilOperator, iters=8):
    """Distributed block-Jacobi: one block per patch, solved approximately
    by a fixed number of Chebyshev iterations (Jacobi inner PC) on the
    patch-truncated operator; linear and symmetric, so valid under CG and
    MINRES. The bound comes from a power iteration on the global vector
    (`estimate_lmax` on the truncated distributed operator); the
    application runs on the local patch alone (B1 with zero ghosts, which
    the truncated entries never read): zero collectives."""
    At = patch_truncate(A)
    local = StencilOperator(At.planes)
    inner = precond.jacobi(local)
    est = precond.estimate_lmax(At, M=inner, template=torch.zeros_like(A.diagonal()))
    return precond.chebyshev_pc(local, inner=inner, lmin=0.1 * 1.1 * est, lmax=1.1 * est, iters=iters)
