"""Preconditioners (PyTorch twin of `saddle_point_petsc_tpu.solvers.precond`).

Every serial PC of the JAX module: IdentityPC, JacobiPC (stencil, CSR,
DIA, block-DIA), PBJacobiPC (point-block Jacobi, stencil and BSR),
BlockJacobiPC (host dense inverses of row blocks applied as one batched
product), ILU0PC (ILU(0) of a CSR: host factorization, device sweeps or
level-scheduled exact solves), RedBlackSORPC (red-black block SOR on the
stencil), ChebyshevPC, `estimate_lmax` (power iteration for Chebyshev
bounds), FieldSplitPC over the two velocity components, the Schur
fieldsplit SchurPC for the KKT system, and KSPInnerPC (an inner Krylov
solve as a PC). Each PC is a frozen dataclass holding tensors, with
`__call__(r) -> z` over the vector structure the Krylov solvers use (a
tensor or a tuple of tensors). Every stencil matvec goes through
`StencilOperator`, so on a CUDA device it launches kernel B1. The ILU(0)
of a stencil operator, with its factors in the planes layout, is
`solvers/ilu_stencil.py`.

Spans (utils/monitor.py): a SchurPC apply runs under `PCApply.Schur`, its
set-up (`schur_pc`) under `PCSetUp.Schur`, and `estimate_lmax`, with its
CPU draw of the start vector, under `PCChebyEigEst`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from saddle_point_petsc_tpu_torch.ops import sparse as sp
from saddle_point_petsc_tpu_torch.ops.cuda import rng
from saddle_point_petsc_tpu_torch.ops.stencil import (
    StencilOperator,
    field_to_flat,
    flat_to_field,
    stencil_to_coo,
)
from saddle_point_petsc_tpu_torch.solvers import krylov
from saddle_point_petsc_tpu_torch.solvers.krylov import chebyshev_iterate
from saddle_point_petsc_tpu_torch.solvers.operators import (
    constraint_apply,
    constraint_apply_t,
)
from saddle_point_petsc_tpu_torch.utils.device import resolve_device
from saddle_point_petsc_tpu_torch.utils.monitor import span


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
    inverse of the Schur approximation. mesh: the ProcessMesh of a
    distributed A (Bf and r_u are then this rank's patches, and B u is
    summed over its ranks), None for a serial one.
    """

    inner_solve: Any
    Bf: torch.Tensor  # (m, 2, ny, nx)
    S_inv: torch.Tensor  # (m, m)
    fact_type: str = "full"
    mesh: Any = None

    def __post_init__(self):
        if self.fact_type not in ("diag", "lower", "upper", "full"):
            raise ValueError(f"unknown Schur fact_type {self.fact_type!r}")

    def _B(self, u):
        Bu = constraint_apply(self.Bf, u)
        return Bu if self.mesh is None else self.mesh.all_reduce(Bu)

    def __call__(self, r):
        with span("PCApply.Schur"):
            ru, rlam = r
            Ainv = self.inner_solve
            if self.fact_type == "diag":
                # the lambda block uses +(B D^-1 B^T)^-1 = -S_inv, since
                # S = -B D^-1 B^T is negative definite
                return (Ainv(ru), -(self.S_inv @ rlam))
            if self.fact_type == "lower":
                zu = Ainv(ru)
                return (zu, self.S_inv @ (rlam - self._B(zu)))
            if self.fact_type == "upper":
                zlam = self.S_inv @ rlam
                return (Ainv(ru - constraint_apply_t(self.Bf, zlam)), zlam)
            # full: L-D-U application
            yu = Ainv(ru)
            zlam = self.S_inv @ (rlam - self._B(yu))
            return (yu - Ainv(constraint_apply_t(self.Bf, zlam)), zlam)


def schur_pc(A, Bf, inner_solve=None, fact_type="full") -> SchurPC:
    """Schur PC with S = -B diag(A)^{-1} B^T (dense m x m).

    A: operator exposing .diagonal() as a (2, ny, nx) field; Bf: the
    constraint rows (m, 2, ny, nx). For a distributed A (one with a mesh)
    both are patches: the m x m partial products are summed over its ranks
    once, here, and the PC keeps the mesh for its B u."""
    with span("PCSetUp.Schur"):
        dinv = _inv_diag(A)
        B2 = Bf.reshape(Bf.shape[0], -1)
        mesh = getattr(A, "mesh", None)
        BDB = (B2 * dinv.reshape(-1)) @ B2.transpose(0, 1)
        if mesh is not None:
            BDB = mesh.all_reduce(BDB)
        if inner_solve is None:
            inner_solve = JacobiPC(dinv)
        return SchurPC(inner_solve, Bf, inv_small(-BDB), fact_type, mesh)  # S = -B D^-1 B^T, negative definite


# ---------------------------------------------------------------------------
# Point-block Jacobi
# ---------------------------------------------------------------------------


def block_apply_field(inv_blocks, r):
    """z[c] = sum_d inv_blocks[y, x, c, d] * r[d, y, x]: (ny, nx, b, b)
    blocks on a dof-major (b, ny, nx) field, elementwise."""
    return (inv_blocks.permute(2, 3, 0, 1) * r[None]).sum(1)


@dataclasses.dataclass(frozen=True)
class PBJacobiPC:
    """Point-block Jacobi: the inverted dof x dof diagonal blocks (PETSc
    PCPBJACOBI), natural for the 2-dof interleaved layout."""

    inv_blocks: torch.Tensor  # (ny, nx, b, b) for a stencil, (mb, b, b) for a BSR

    def __call__(self, r):
        b = self.inv_blocks.shape[-1]
        if r.ndim == 1:  # natural interleaved flat vector
            ib = self.inv_blocks.reshape(-1, b, b)
            return (ib * r.reshape(-1, 1, b)).sum(-1).reshape(-1)
        if r.ndim == 3 and r.shape[0] == b:  # dof-major (b, ny, nx) field
            return block_apply_field(self.inv_blocks, r)
        return (self.inv_blocks * r[..., None, :]).sum(-1)


def pbjacobi(A) -> PBJacobiPC:
    """Point-block Jacobi of a stencil operator (serial or distributed: the
    blocks of the rank's patch) or a BSR."""
    if isinstance(A, sp.BSR):
        return PBJacobiPC(inv_small(sp.bsr_extract_diag_blocks(A)))
    if hasattr(A, "diag_blocks"):
        return PBJacobiPC(inv_small(A.diag_blocks()))
    raise TypeError(f"pbjacobi: unsupported operator {type(A)}")


# ---------------------------------------------------------------------------
# Domain block-Jacobi with dense sub-solves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockJacobiPC:
    """Contiguous row blocks, each solved exactly by a precomputed dense
    inverse, applied as one batched (nb, bs, bs) x (nb, bs) product (PETSc
    PCBJACOBI with an exact sub-solve). The inverses are computed on the
    host at setup."""

    inv: torch.Tensor  # (nb, bs, bs) dense block inverses
    n: int  # true vector length (the last block is padded)

    def __call__(self, r):
        shape = r.shape
        field = r.ndim == 3 and shape[0] == 2
        # a dof-major field goes to the natural flat ordering of the rows
        # the blocks were cut from
        flat = field_to_flat(r) if field else r.reshape(-1)
        nb, bs, _ = self.inv.shape
        rp = F.pad(flat, (0, nb * bs - self.n)).reshape(nb, bs, 1)
        z = torch.bmm(self.inv, rp).reshape(-1)[: self.n]
        return flat_to_field(z, shape[1], shape[2]) if field else z.reshape(shape)


def block_jacobi(A, nblocks=4, max_block=4096, device=None) -> BlockJacobiPC:
    """Host setup: cut nblocks equal diagonal blocks (the last padded with
    identity) and invert them with numpy.

    A: a CSR, a scipy sparse matrix, or a dense numpy array or tensor. The
    inverses go to A's device (a CSR's or tensor's), else to `device`
    (None: the CUDA card). With more blocks than rows need (nblocks * bs -
    n >= bs), the trailing blocks hold padding alone and are identity; the
    JAX function raises there. Blocks are capped at `max_block` rows, raising
    the block count as needed: a dense inverse is O(bs^2) memory and
    O(bs^3) setup (PETSc's PCBJACOBI likewise picks the count under
    PETSC_DECIDE).
    """
    import scipy.sparse as sps

    if isinstance(A, sp.CSR):
        a, device = sp.csr_to_scipy(A), A.vals.device
    elif isinstance(A, torch.Tensor):
        a, device = A.detach().cpu().numpy(), A.device
    else:
        a, device = A, resolve_device(device)
    if sps.issparse(a):
        a = a.tocsr()

        def get(lo, hi):
            return a[lo:hi, lo:hi].toarray()
    else:
        a = np.asarray(a)

        def get(lo, hi):
            return a[lo:hi, lo:hi]

    n = a.shape[0]
    nblocks = max(nblocks, -(-n // max_block))
    bs = -(-n // nblocks)
    blocks = np.zeros((nblocks, bs, bs), a.dtype)
    for k in range(nblocks):
        lo, hi = k * bs, min((k + 1) * bs, n)
        m = max(hi - lo, 0)  # trailing blocks may hold padding alone
        if m:
            blocks[k, :m, :m] = get(lo, hi)
        if m < bs:
            blocks[k, m:, m:] = np.eye(bs - m)
    return BlockJacobiPC(torch.tensor(np.linalg.inv(blocks), device=device), n)


def block_jacobi_stencil(op: StencilOperator, nblocks=4) -> BlockJacobiPC:
    """Block-Jacobi over row strips of a stencil operator (host setup), in
    the planes' dtype and on their device."""
    import scipy.sparse as sps

    rows, cols, vals = stencil_to_coo(op.W)
    keep = rows >= 0  # drop out-of-grid padding
    a = sps.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=op.shape)
    return block_jacobi(a, nblocks, device=op.planes.device)


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------

def factor_values(indptr, indices, data, n):
    """ILU(0) of a CSR with sorted column indices, on the host in f64: the
    factored values in the same pattern, by the native library
    (`utils/native.ilu0`) or, when it does not load, by `_ilu0_python`.

    Raises ValueError on a missing diagonal (as the JAX package, whose
    native call raises there and whose Python fallback names the row) and
    ZeroDivisionError on a zero pivot (where the JAX package falls back to
    its Python loop, which divides by zero and returns non-finite factors).
    """
    from saddle_point_petsc_tpu_torch.utils import native

    rows = np.repeat(np.arange(n), np.diff(indptr))
    has_diag = np.zeros(n, bool)
    has_diag[rows[indices == rows]] = True
    if not has_diag.all():
        raise ValueError(f"ILU0: missing diagonal in row {int(np.argmin(has_diag))}")
    try:
        return native.ilu0(indptr, indices, data, n)
    except native.NativeUnavailable:
        return _ilu0_python(indptr, indices, np.array(data, dtype=np.float64), n)


def _ilu0_python(indptr, indices, data, n):
    """Reference ILU(0) in Python, in place on `data` (slow: the native
    library is preferred). The JAX package's loop, plus the zero-pivot
    check of the native code. Each update rounds its product and its
    difference apart, where the native code fuses them, so the two differ
    by ulps."""
    diag_idx = np.zeros(n, np.int64)
    colpos = {}
    for i in range(n):
        row = slice(indptr[i], indptr[i + 1])
        cols = indices[row]
        colpos[i] = {c: indptr[i] + k for k, c in enumerate(cols)}
        d = colpos[i].get(i)
        if d is None:
            raise ValueError(f"ILU0: missing diagonal in row {i}")
        diag_idx[i] = d
    for i in range(n):
        for kk in range(indptr[i], indptr[i + 1]):
            k = indices[kk]
            if k >= i:
                break
            akk = data[diag_idx[k]]
            if akk == 0.0:
                raise ZeroDivisionError(f"ILU(0): zero pivot at row {k}")
            data[kk] /= akk
            lik = data[kk]
            rowk = colpos[k]
            for jj in range(kk + 1, indptr[i + 1]):
                j = indices[jj]
                pos = rowk.get(j)
                if pos is not None and j > k:
                    data[jj] -= lik * data[pos]
    return data


def _factored(csr: sp.CSR):
    """The ILU(0) factors of a CSR in one scipy CSR of f64 values (host)."""
    import scipy.sparse as sps

    a = sp.csr_to_scipy(csr).astype(np.float64)  # a copy
    a.sort_indices()
    data = factor_values(a.indptr, a.indices, a.data, a.shape[0])
    return sps.csr_matrix((data, a.indices, a.indptr), shape=a.shape)


def ilu0_factor_host(csr: sp.CSR):
    """ILU(0) factorization on the host (setup time): the IKJ algorithm
    restricted to A's pattern, in f64 (`factor_values`). Returns (L, U) as
    CSRs on the CSR's device and in its dtype: L strictly lower (unit
    diagonal implied), U upper with the diagonal."""
    import scipy.sparse as sps

    f = _factored(csr)
    dev, dt = csr.vals.device, csr.vals.dtype
    return (sp.scipy_to_csr(sps.tril(f, k=-1).tocsr(), device=dev, dtype=dt),
            sp.scipy_to_csr(sps.triu(f, k=0).tocsr(), device=dev, dtype=dt))


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """The rows of a strictly triangular factor grouped into levels for an
    exact solve: a row's level is one more than the highest level among
    the rows it depends on (0 for none), so the rows of one level depend
    only on earlier levels and are solved together.

    Rows are stored in level order with their ELL columns and values
    (padding: column 0, value 0); level l is rows[bounds[l]:bounds[l+1]].
    `scale` (the inverted diagonal for U, None for the unit-diagonal L) is
    stored in the same order."""

    rows: torch.Tensor  # (n,) int64
    cols: torch.Tensor  # (n, k) int64
    vals: torch.Tensor  # (n, k)
    bounds: tuple  # Python ints, levels + 1 of them
    scale: Optional[torch.Tensor] = None  # (n,)

    @property
    def levels(self):
        return len(self.bounds) - 1

    def solve(self, r):
        """x with x[i] = scale[i] * (r[i] - sum_j T[i, j] x[j]): per level one
        gather of x, one slot sum and one scatter, on r's device."""
        x = torch.zeros_like(r)
        rp = r[self.rows]
        for a, b in zip(self.bounds[:-1], self.bounds[1:]):
            v = rp[a:b] - (self.vals[a:b] * x[self.cols[a:b]]).sum(-1)
            if self.scale is not None:
                v = self.scale[a:b] * v
            x[self.rows[a:b]] = v
        return x


def level_schedule(t, upper, device, dtype, scale=None) -> LevelSchedule:
    """LevelSchedule of a strictly lower (upper=False) or strictly upper
    scipy CSR `t` from its pattern (host, setup time; a Python loop over
    the rows). `scale` is a tensor of the row count, or None."""
    indptr, indices = t.indptr, t.indices
    n = t.shape[0]
    level = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1) if upper else range(n):
        s, e = indptr[i], indptr[i + 1]
        if e > s:
            level[i] = level[indices[s:e]].max() + 1
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(level.max(initial=-1) + 2))
    counts = np.diff(indptr)
    k = int(counts.max(initial=0))
    rows = np.repeat(np.arange(n), counts)
    slot = np.arange(len(indices)) - indptr[rows]
    cols = np.zeros((n, k), np.int64)
    vals = np.zeros((n, k))
    cols[rows, slot] = indices
    vals[rows, slot] = t.data
    perm = torch.tensor(order, device=device)
    return LevelSchedule(
        perm,
        torch.tensor(cols[order], device=device),
        torch.tensor(vals[order], dtype=dtype, device=device),
        tuple(int(b) for b in bounds),
        None if scale is None else scale[perm],
    )


@dataclasses.dataclass(frozen=True)
class ILU0PC:
    """Apply z = U^{-1} L^{-1} r (PETSc PCILU, zero fill).

    sweeps > 0: fixed-count Jacobi sweeps on each triangular factor, 2 x
    sweeps CSR matvecs (`sp.csr_matvec`) and elementwise updates an apply;
    approximate, exact as sweeps -> n.
    sweeps == 0: the exact triangular solves, level by level
    (`LevelSchedule.solve`, for validation and small systems): 5-6
    launches a level on a CUDA device, and the level count of a natural
    ordering grows with the grid, about 6 x the side for the 2-dof 9-point
    stencil (L and U: 386 and 374 levels at 65^2 nodes, 1538 and 1526 at
    257^2), so an apply is launch-bound (57 ms at 65^2 on an H100). The
    JAX package scans over the rows one at a time.

    Input: a flat vector in the CSR's row order, a dof-major (2, ny, nx)
    field (taken to the natural interleaved ordering and back), or any
    other shape (flattened and reshaped back).
    """

    L: sp.CSR  # strictly lower
    U: sp.CSR  # strictly upper
    inv_udiag: torch.Tensor  # (n,)
    lower: Optional[LevelSchedule]  # the exact path's schedules (sweeps == 0)
    upper: Optional[LevelSchedule]
    sweeps: int = 6

    def __call__(self, r):
        field = None
        if r.ndim == 3 and r.shape[0] == 2:
            field = r.shape
            r = field_to_flat(r)
        elif r.ndim != 1:
            field = ("reshape",) + tuple(r.shape)
            r = r.reshape(-1)
        if self.sweeps > 0:
            # (I + L) y = r, unit diagonal: y <- r - L y
            y = r
            for _ in range(self.sweeps):
                y = r - sp.csr_matvec(self.L, y)
            # (D + U_strict) z = y: z <- Dinv * (y - U_strict z)
            z = self.inv_udiag * y
            for _ in range(self.sweeps):
                z = self.inv_udiag * (y - sp.csr_matvec(self.U, z))
            out = z
        else:
            out = self.upper.solve(self.lower.solve(r))
        if field is None:
            return out
        if field[0] == "reshape":
            return out.reshape(field[1:])
        return flat_to_field(out, field[1], field[2])


def ilu0(csr: sp.CSR, sweeps: int = 6) -> ILU0PC:
    """ILU(0) preconditioner of a CSR: host factorization in f64; L, the
    strictly upper U, the inverted diagonal of U and (sweeps == 0) the
    level schedules on the CSR's device in its dtype."""
    import scipy.sparse as sps

    f = _factored(csr)
    dev, dt = csr.vals.device, csr.vals.dtype
    L = sps.tril(f, k=-1).tocsr()
    Us = sps.triu(f, k=1).tocsr()
    Us.eliminate_zeros()
    ud = torch.tensor(f.diagonal(), dtype=dt, device=dev)
    inv_ud = 1.0 / torch.where(ud == 0, 1.0, ud)
    lower = upper = None
    if sweeps == 0:
        lower = level_schedule(L, False, dev, dt)
        upper = level_schedule(Us, True, dev, dt, scale=inv_ud)
    return ILU0PC(sp.scipy_to_csr(L, device=dev, dtype=dt), sp.scipy_to_csr(Us, device=dev, dtype=dt),
                  inv_ud, lower, upper, sweeps)


# ---------------------------------------------------------------------------
# Red-black SOR (structured grids)
# ---------------------------------------------------------------------------

_SOR_ORDERS = ("symmetric", "forward", "backward")


@dataclasses.dataclass(frozen=True)
class RedBlackSORPC:
    """Red-black block Gauss-Seidel/SOR on a stencil operator.

    The 9-point stencil couples each node only to the other colour of the
    (i + j) 2-colouring in its 5-point part; with the full box stencil the
    colouring is approximate Gauss-Seidel, still an effective smoother.
    Each half-sweep is a whole-grid stencil matvec (kernel B1 on a CUDA
    device), a point-block solve and a colour-masked update: no sequential
    dependence.

    order: "symmetric" (red, black, black, red: a symmetric PC, valid
    under CG/MINRES; 4 matvecs a sweep), "forward" (red, black) or
    "backward" (black, red), 2 matvecs a sweep. A V-cycle with forward
    pre- and backward post-smoothing is symmetric as a whole
    (solvers/multigrid.py, smoother "sor-fb"). The colour masks are built
    once, at construction, over the operator's planes: the whole grid, or
    a distributed operator's patch with the parity of its global origin,
    so that every rank colours its nodes as the global grid does and each
    half-step is one distributed matvec.
    """

    op: StencilOperator
    inv_blocks: torch.Tensor  # (ny, nx, 2, 2)
    omega: float = 1.0
    sweeps: int = 1
    order: str = "symmetric"
    colors: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.order not in _SOR_ORDERS:
            raise ValueError(f"sor order {self.order!r}: use one of {_SOR_ORDERS}")
        ny, nx = self.op.planes.shape[-2:]
        j0, i0 = getattr(self.op, "origin", (0, 0))
        dev = self.op.planes.device
        j = torch.arange(j0, j0 + ny, device=dev)[:, None]
        i = torch.arange(i0, i0 + nx, device=dev)[None, :]
        red = ((i + j) % 2 == 0)[None]
        black = ~red
        colors = {
            "symmetric": (red, black, black, red),
            "forward": (red, black),
            "backward": (black, red),
        }[self.order]
        object.__setattr__(self, "colors", colors)  # frozen: set once, here

    def __call__(self, r):
        flat = r.ndim == 1
        if flat:
            r = flat_to_field(r, *self.op.grid_shape)
        z = torch.zeros_like(r)
        for _ in range(self.sweeps):
            for mask in self.colors:
                dz = block_apply_field(self.inv_blocks, r - self.op.matvec_field(z))
                z = z + self.omega * torch.where(mask, dz, 0.0)
        return field_to_flat(z) if flat else z


def sor(op: StencilOperator, omega=1.0, sweeps=1, order="symmetric") -> RedBlackSORPC:
    return RedBlackSORPC(op, inv_small(op.diag_blocks()), omega, sweeps, order)


# ---------------------------------------------------------------------------
# Spectral bound for Chebyshev
# ---------------------------------------------------------------------------


def _start_vector(template, generator):
    """The power iteration's start: standard normal draws shaped like
    `template` (a tensor or a tuple of tensors), made on the template's
    device by the counter-based generator of ops/cuda/rng.py (kernel RN on
    the card, its bit-matching twin on the CPU), keyed by the seed
    (`generator.initial_seed()`, 0 for None) and each leaf's index in the
    tuple. Element k of a leaf depends only on (seed, leaf, k), so a CPU and
    a CUDA build of the same operator start from the same vector."""
    seed = 0 if generator is None else generator.initial_seed()
    if isinstance(template, tuple):
        return tuple(rng.normal_like(a, seed, leaf) for leaf, a in enumerate(template))
    return rng.normal_like(template, seed)


@krylov.reduces_over_ranks
def estimate_lmax(A, M=None, iters=10, generator=None, template=None):
    """Power-iteration estimate of lambda_max(M A) for Chebyshev bounds, as
    a Python float.

    `template` gives the vector structure, shape, dtype and device; the
    start vector comes from `_start_vector` with `generator`, a
    torch.Generator whose initial seed keys the draw (default: seed 0),
    where the JAX function takes a PRNG key: standard normals drawn on the
    template's device (one RN launch a leaf on the card) by a counter-based
    generator, so the CPU and the card start alike. The loop stays on the
    device and syncs once, at the end.

    For a distributed A (one with a mesh) the template's leaves lie as A
    declares (`krylov.distribution()`): every rank draws the global start
    vector with the same seed on its leaves' device and keeps its patch or
    rows of each rank-local leaf, and the norms sum over the ranks, so the
    estimate is the serial one of the global operator. A patch is cut where
    A puts it (`A.global_like`, `A.local_patch`: an unequal tiling of a
    multigrid level), else where the mesh does.
    """
    if template is None:
        raise ValueError("need a template vector")
    with span("PCChebyEigEst"):
        M = M or IdentityPC()
        d = krylov.distribution()
        if d is None:
            v = _start_vector(template, generator)
        else:
            leaves = template if isinstance(template, tuple) else (template,)
            tiles = A if hasattr(A, "local_patch") else d.mesh
            layouts = {"patch": (tiles.global_like, tiles.local_patch),
                       "rows": (d.mesh.global_rows_like, d.mesh.local_rows),
                       None: (lambda a: a, lambda g: g)}
            kinds = [layouts[k] for k in d.leaves]
            draw = _start_vector(tuple(glob(a) for (glob, _), a in zip(kinds, leaves, strict=True)), generator)
            v = tuple(loc(g).to(a.device).contiguous() for (_, loc), g, a in zip(kinds, draw, leaves))
            v = v if isinstance(template, tuple) else v[0]
        lam = None
        for _ in range(iters):
            w = M(A(v))
            lam = krylov.tnorm(w)
            v = krylov.tscale(1.0 / lam, w)
        return 1.0 if lam is None else lam.item()


# ---------------------------------------------------------------------------
# FieldSplit over the velocity components (stencil)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScalarStencilOp:
    """Scalar 9-point stencil operator for one (c, d) dof block, in the
    planes layout (3, 3, ny, nx): one plane group of
    StencilOperator.planes. Its matvec is nine shifted multiply-adds in
    plain PyTorch (in the JAX package, XLA operations)."""

    Ws: torch.Tensor  # (3, 3, ny, nx)

    def pad(self, x):
        """x with its ring of zero (Dirichlet) ghosts."""
        return F.pad(x, (1, 1, 1, 1))

    def __call__(self, x):
        ny, nx = self.Ws.shape[-2:]
        xp = self.pad(x)
        y = torch.zeros_like(x)
        for dj in range(3):
            for di in range(3):
                y = y + self.Ws[dj, di] * xp[dj : dj + ny, di : di + nx]
        return y

    def diagonal(self):
        return self.Ws[1, 1]


_FS_TYPES = ("additive", "multiplicative")


@dataclasses.dataclass(frozen=True)
class FieldSplitPC:
    """Additive or multiplicative fieldsplit over the two velocity
    components of the interleaved-dof layout (PETSc PCFIELDSPLIT with
    DMDA field names). "additive" is block-diagonal; "multiplicative" is
    block Gauss-Seidel over the fields, applying the A10 coupling."""

    A10: ScalarStencilOp  # field 1 rows, field 0 columns
    sub0: Any  # PC of the field-0 block
    sub1: Any
    fs_type: str = "additive"

    def __post_init__(self):
        if self.fs_type not in _FS_TYPES:
            raise ValueError(f"fieldsplit type {self.fs_type!r}: use one of {_FS_TYPES}")

    def __call__(self, r):
        flat = r.ndim == 1
        if flat:
            r = flat_to_field(r, *self.A10.Ws.shape[-2:])
        r0, r1 = r[0], r[1]
        z0 = self.sub0(r0)
        if self.fs_type == "multiplicative":
            r1 = r1 - self.A10(z0)
        z = torch.stack([z0, self.sub1(r1)])
        return field_to_flat(z) if flat else z


def fieldsplit(op: StencilOperator, sub="jacobi", fs_type="additive") -> FieldSplitPC:
    if sub != "jacobi":
        raise ValueError(f"fieldsplit sub-PC {sub!r} unsupported")
    subs = [jacobi(ScalarStencilOp(op.planes[3 * c])) for c in range(2)]  # (c, c) blocks
    return FieldSplitPC(ScalarStencilOp(op.planes[2]), subs[0], subs[1], fs_type)


# ---------------------------------------------------------------------------
# Inner KSP as a PC (FGMRES, Schur A-block solves)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KSPInnerPC:
    """An inner Krylov solve as a (generally nonlinear) PC, for FGMRES.
    solver: a name in krylov.SOLVERS; tolerance and iteration cap fixed at
    construction."""

    A: Any
    M: Any
    solver: str = "cg"
    rtol: float = 1e-2
    maxiter: int = 10

    def __post_init__(self):
        if self.solver not in krylov.SOLVERS:
            raise ValueError(f"unknown inner ksp_type {self.solver!r}")

    def __call__(self, r):
        fn = krylov.SOLVERS[self.solver]
        return fn(self.A, r, M=self.M, rtol=self.rtol, maxiter=self.maxiter).x
