"""Algebraic multigrid, smoothed aggregation, serial (PyTorch twin of the
serial part of `saddle_point_petsc_tpu.solvers.amg`; PETSc -pc_type gamg).

- **Setup runs on the host**, as PETSc's PCSetUp does, with the JAX
  package's numpy/scipy algorithm: strength graph, greedy aggregation
  (the shared native `aggregate`, with the pure-Python fallback when the
  library does not load), the piecewise-constant tentative prolongator
  smoothed by one damped-Jacobi step, Galerkin products, and per-level
  spectral bounds for the Chebyshev smoother.
- **The cycle runs on the operator's device.** Each level operator is DIA
  (kernel B3 on a CUDA device) when its bands fit, ELL (kernel B5)
  otherwise. The
  transfer operators are never stored: prolongation is s * xc[agg] and
  one level matvec, restriction one level matvec and an `index_add_`.
  The coarsest level is a dense matrix-vector product with a
  host-computed inverse.

V-cycle (or W-cycle) with R = P^T and the same symmetric Chebyshev
smoother before and after, so the PC is SPD for SPD A (valid under CG and
MINRES). The distributed hierarchy (`dist_amg_pc`) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.ops import sparse as sp
from saddle_point_petsc_tpu_torch.ops.stencil import (
    StencilOperator,
    field_to_flat,
    flat_to_field,
    stencil_to_coo,
)
from saddle_point_petsc_tpu_torch.solvers import precond


@dataclasses.dataclass(frozen=True)
class _EllOp:
    """An ELL matrix as a Krylov/PC operator. The ELL holds kernel B5's
    slot-major int32 copy, built once with the level, so each matvec
    launches B5 on a CUDA device without a transpose."""

    ell: sp.ELL

    def __call__(self, x):
        return sp.ell_matvec(self.ell, x)

    def diagonal(self):
        m, _ = self.ell.shape
        hit = self.ell.cols == torch.arange(m, device=self.ell.cols.device)[:, None]
        return torch.sum(torch.where(hit, self.ell.vals, 0.0), dim=1)


@dataclasses.dataclass(frozen=True)
class AMGLevel:
    """One SA-AMG level with factored transfer operators.

    agg[i] = aggregate (coarse node) of fine node i; s[i] = 1/sqrt(size of
    that aggregate); dinv = the level's inverse diagonal; omega = the
    prolongator smoothing weight 4/3 / rho(D^-1 A)."""

    A: Any  # sp.DIA or _EllOp
    agg: torch.Tensor  # (n_f,) int64
    s: torch.Tensor  # (n_f,)
    dinv: torch.Tensor  # (n_f,)
    smoother: Any  # precond.ChebyshevPC
    omega: float
    n_c: int

    def prolong(self, xc):
        """P xc = (I - omega D^-1 A) (s * xc[agg])."""
        t = self.s * xc[self.agg]
        return t - self.omega * (self.dinv * self.A(t))

    def restrict(self, r):
        """P^T r = P0^T (r - omega A D^-1 r)   (A symmetric)."""
        u = r - self.omega * self.A(self.dinv * r)
        out = torch.zeros((self.n_c,), dtype=u.dtype, device=u.device)
        return out.index_add_(0, self.agg, self.s * u)


@dataclasses.dataclass(frozen=True)
class AMGPC:
    """Smoothed-aggregation AMG cycle as a symmetric, linear PC.

    cycles: 1 = V-cycle, 2 = W-cycle (PETSc -pc_mg_cycles). field_shape is
    (ny, nx) when built from a stencil operator, whose (2, ny, nx) fields
    are flattened to the natural order around the cycle."""

    levels: Tuple[AMGLevel, ...]
    coarse_inv: Any  # inverse of the coarsest Galerkin operator: a dense
    # tensor, or a SplitCoarseInverse above the dense-solve cap
    cycles: int = 1
    field_shape: Any = None

    def __call__(self, r):
        field = r.ndim == 3 and self.field_shape is not None
        if field:
            r = field_to_flat(r)
        # an empty hierarchy (input already <= coarse_max rows): the coarse
        # solve is exact, apply it directly
        z = self._vcycle(0, r) if self.levels else self.coarse_inv @ r
        if field:
            z = flat_to_field(z, *self.field_shape)
        return z

    def _vcycle(self, k, r):
        if k == len(self.levels):
            return self.coarse_inv @ r
        lvl = self.levels[k]
        z = lvl.smoother(r)  # pre-smooth from a zero initial guess
        rc = lvl.restrict(r - lvl.A(z))
        zc = self._vcycle(k + 1, rc)
        if self.cycles >= 2 and k + 1 < len(self.levels):
            # W-cycle: recurse again on the updated coarse residual
            # (not at the coarsest level, whose solve is exact)
            zc = zc + self._vcycle(k + 1, rc - self.levels[k + 1].A(zc))
        z = z + lvl.prolong(zc)
        return z + lvl.smoother(r - lvl.A(z))  # post-smooth


# ---------------------------------------------------------------------------
# Host-side setup (numpy/scipy, the JAX package's algorithm)
# ---------------------------------------------------------------------------

# a dense f64 inverse above this many coarse rows would not fit a host
_COARSE_HARD_CAP = 4096


@dataclasses.dataclass(frozen=True)
class SplitCoarseInverse:
    """The inverse of a coarsest operator that is block diagonal between
    decoupled rows (only a diagonal entry in their row and column) and the
    rest: a reciprocal per decoupled row and a dense inverse of the rest.
    `inv @ r` applies it, as for a dense inverse.

    Eliminated Dirichlet rows never aggregate (a singleton on every
    level), so on an n x n-node grid the coarsest level keeps 8(n-1) of
    them: above 513 x 513 nodes they alone pass the dense-solve cap, where
    the JAX package raises. Splitting them off is exact."""

    iso: torch.Tensor  # (k,) decoupled rows
    iso_inv: torch.Tensor  # (k,) their reciprocal diagonals
    rest: torch.Tensor  # (r,) the other rows
    rest_inv: torch.Tensor  # (r, r) dense inverse of the rest

    @property
    def shape(self):
        n = self.iso.shape[0] + self.rest.shape[0]
        return (n, n)

    def __matmul__(self, r):
        z = torch.empty_like(r)
        z[self.iso] = self.iso_inv * r[self.iso]
        z[self.rest] = self.rest_inv @ r[self.rest]
        return z


def _coarse_inverse(Asp, dtype, device):
    """The coarsest level's inverse on `device`: dense, as the JAX package
    computes it, while the level fits the dense-solve cap; above it, split
    into decoupled rows and a dense rest when the rest fits."""
    n = Asp.shape[0]
    if n <= _COARSE_HARD_CAP:
        return torch.tensor(_coarse_inv_np(Asp), dtype=dtype, device=device)
    a = Asp.tocoo()
    off = (a.row != a.col) & (a.data != 0)
    coupled = np.zeros(n, bool)
    coupled[a.row[off]] = True
    coupled[a.col[off]] = True
    rest = np.flatnonzero(coupled | (Asp.diagonal() == 0))
    if rest.size > _COARSE_HARD_CAP:
        raise ValueError(
            f"gamg: coarsest level still has {rest.size} coupled rows of {n} "
            f"(dense-solve cap {_COARSE_HARD_CAP}); raise -pc_mg_levels "
            "or lower -pc_gamg_coarse_eq_limit"
        )
    iso = np.setdiff1d(np.arange(n), rest)
    rest_inv = _coarse_inv_np(Asp.tocsr()[rest][:, rest]) if rest.size else np.zeros((0, 0))

    def t(a, **kw):
        return torch.tensor(a, device=device, **kw)

    return SplitCoarseInverse(
        t(iso), t(1.0 / Asp.diagonal()[iso], dtype=dtype), t(rest), t(rest_inv, dtype=dtype)
    )


def _coarse_inv_np(Asp):
    """Dense inverse of the coarsest Galerkin operator; a (near-)singular
    one (e.g. pure Neumann) gets the Moore-Penrose pseudoinverse."""
    if Asp.shape[0] > _COARSE_HARD_CAP:
        raise ValueError(
            f"gamg: coarsest level still has {Asp.shape[0]} rows "
            f"(dense-solve cap {_COARSE_HARD_CAP}); raise -pc_mg_levels "
            "or lower -pc_gamg_coarse_eq_limit"
        )
    dense = np.asarray(Asp.toarray(), np.float64)
    try:
        inv = np.linalg.inv(dense)
        cond = np.linalg.norm(dense, 1) * np.linalg.norm(inv, 1)
        if not np.isfinite(cond) or cond > 1e12:
            raise np.linalg.LinAlgError("ill-conditioned coarse operator")
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(dense, rcond=1e-10)
    return inv


def _to_scipy(A):
    """A CSR, DIA, stencil or scipy operator -> scipy csr_matrix (host).
    Block-DIA is refused, as in the JAX package."""
    import scipy.sparse as sps

    if isinstance(A, (sp.CSR, sp.DIA)):
        return sp.to_scipy(A).tocsr()
    if sps.issparse(A):
        return A.tocsr()
    if isinstance(A, StencilOperator):
        rows, cols, vals = stencil_to_coo(A.W)
        vals = vals.astype(np.float64)
        keep = (rows >= 0) & (cols >= 0)  # drop out-of-grid padding
        return sps.coo_matrix((vals[keep], (rows[keep], cols[keep])), shape=A.shape).tocsr()
    raise TypeError(f"gamg: unsupported operator {type(A).__name__}")


def _strength_graph(Asp, theta):
    """Symmetric strength of connection: off-diagonal (i, j) with
    |a_ij| >= theta * sqrt(|a_ii a_jj|). theta = 0 keeps the whole graph."""
    import scipy.sparse as sps

    a = Asp.tocoo()
    d = np.abs(Asp.diagonal())
    d = np.where(d == 0.0, 1.0, d)
    off = a.row != a.col
    strong = off & (np.abs(a.data) >= theta * np.sqrt(d[a.row] * d[a.col]))
    S = sps.csr_matrix(
        (np.ones(np.count_nonzero(strong), np.int8), (a.row[strong], a.col[strong])),
        shape=Asp.shape,
    )
    return S.maximum(S.T)


def _aggregate_numpy(indptr, indices, n):
    """Pure-Python fallback for native.aggregate (the same 3-pass greedy
    algorithm; minutes at a million rows)."""
    agg = -np.ones(n, np.int32)
    na = 0
    for i in range(n):  # pass 1: roots whose whole neighbourhood is free
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        if np.all(agg[nb] < 0):
            agg[i] = na
            agg[nb] = na
            na += 1
    attach = -np.ones(n, np.int32)  # pass 2: join a neighbouring aggregate
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        hit = agg[nb]
        hit = hit[hit >= 0]
        if hit.size:
            attach[i] = hit[0]
    agg = np.where(attach >= 0, attach, agg)
    for i in range(n):  # pass 3: new aggregates from what is left
        if agg[i] >= 0:
            continue
        agg[i] = na
        nb = indices[indptr[i] : indptr[i + 1]]
        free = nb[agg[nb] < 0]
        agg[free] = na
        na += 1
    return agg, int(na)


aggregation_route = None  # "native" or "numpy": which one the last setup ran


def _aggregate(S):
    global aggregation_route
    n = S.shape[0]
    try:
        from saddle_point_petsc_tpu_torch.utils import native

        out = native.aggregate(S.indptr, S.indices, n)
        aggregation_route = "native"
    except Exception:
        out = _aggregate_numpy(S.indptr, S.indices, n)
        aggregation_route = "numpy"
    return out


def _rho_dinv_a(Asp, iters=15, seed=0):
    """Power-iteration estimate of the spectral radius of D^-1 A (host)."""
    d = Asp.diagonal()
    d = np.where(d == 0.0, 1.0, d)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(Asp.shape[0])
    lam = 1.0
    for _ in range(iters):
        w = (Asp @ v) / d
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam


def _scipy_to_ell(Asp, dtype, device):
    Asp = Asp.tocsr()
    Asp.sort_indices()
    counts = np.diff(Asp.indptr)
    k = max(int(counts.max()) if counts.size else 1, 1)
    m = Asp.shape[0]
    cols = -np.ones((m, k), np.int64)
    vals = np.zeros((m, k), np.float64)
    rows_of = np.repeat(np.arange(m), counts)
    slot = np.arange(Asp.nnz) - np.repeat(Asp.indptr[:-1], counts)
    cols[rows_of, slot] = Asp.indices
    vals[rows_of, slot] = Asp.data
    return sp.ELL(
        torch.tensor(cols, device=device),
        torch.tensor(vals, dtype=dtype, device=device),
        tuple(Asp.shape),
    )


def _scipy_to_level_op(Asp, dtype, device, max_diag_blowup=4.0, max_diags=512):
    """DIA when the distinct offsets keep the padded storage within
    `max_diag_blowup` x nnz (and at most `max_diags` bands), ELL otherwise."""
    coo = Asp.tocoo()
    offs = np.unique(coo.col - coo.row)
    n = Asp.shape[0]
    if len(offs) <= max_diags and len(offs) * n <= max_diag_blowup * max(Asp.nnz, 1):
        data = np.zeros((len(offs), n), np.float64)
        d_idx = np.searchsorted(offs, coo.col - coo.row)
        data[d_idx, coo.row] = coo.data
        return sp.DIA(
            torch.tensor(data, dtype=dtype, device=device),
            tuple(int(o) for o in offs),
            tuple(Asp.shape),
        )
    return _EllOp(_scipy_to_ell(Asp, dtype, device))


_NP_TO_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _dtype_device(A):
    """The floating dtype and the device of an operator's tensors."""
    for t in (getattr(A, f, None) for f in ("vals", "data", "planes")):
        if isinstance(t, torch.Tensor):
            return t.dtype, t.device
    return _NP_TO_TORCH.get(np.dtype(getattr(A, "dtype", np.float32)), torch.float32), torch.device("cpu")


def amg_pc(
    A,
    opts=None,
    theta=0.08,
    coarse_max=500,
    max_levels=10,
    smooth_its=2,
    cycles=1,
    dtype=None,
) -> AMGPC:
    """Build the smoothed-aggregation hierarchy (host) and the PC (on A's
    device). Options, by PETSc PCGAMG names: -pc_gamg_threshold,
    -pc_gamg_coarse_eq_limit, -pc_mg_levels, -pc_mg_cycles (1 = V,
    2 = W), -pc_gamg_smooth_its (the smoother's Chebyshev degree)."""
    import scipy.sparse as sps

    if opts is not None:
        theta = opts.get_float("pc_gamg_threshold", theta)
        coarse_max = opts.get_int("pc_gamg_coarse_eq_limit", coarse_max)
        max_levels = opts.get_int("pc_mg_levels", max_levels)
        cycles = opts.get_int("pc_mg_cycles", cycles)
        smooth_its = opts.get_int("pc_gamg_smooth_its", smooth_its)

    Asp = _to_scipy(A).astype(np.float64)
    op_dtype, device = _dtype_device(A)
    dtype = op_dtype if dtype is None else dtype
    levels = []
    while len(levels) < max_levels - 1 and Asp.shape[0] > coarse_max:
        n = Asp.shape[0]
        S = _strength_graph(Asp, theta)
        agg, na = _aggregate(S)
        if na >= n:  # no coarsening possible (e.g. a diagonal matrix)
            break
        # tentative piecewise-constant prolongator, columns normalized
        sizes = np.bincount(agg, minlength=na).astype(np.float64)
        svec = 1.0 / np.sqrt(sizes[agg])
        P0 = sps.csr_matrix((svec, (np.arange(n), agg)), shape=(n, na))
        # smooth: P = (I - omega D^-1 A) P0,  omega = (4/3) / rho(D^-1 A)
        rho = _rho_dinv_a(Asp)
        omega = 4.0 / (3.0 * rho)
        d = Asp.diagonal()
        d = np.where(d == 0.0, 1.0, d)
        P = (P0 - omega * (sps.diags(1.0 / d) @ (Asp @ P0))).tocsr()
        Ac = (P.T @ Asp @ P).tocsr()
        Ac.eliminate_zeros()
        # level smoother: Chebyshev(Jacobi) on [rho/4, 1.1 rho]
        A_op = _scipy_to_level_op(Asp, dtype, device)
        inv_diag = torch.tensor(1.0 / d, dtype=dtype, device=device)
        sm = precond.ChebyshevPC(
            A_op, precond.JacobiPC(inv_diag), lmin=rho / 4.0, lmax=1.1 * rho, iters=smooth_its
        )
        levels.append(
            AMGLevel(
                A_op,
                torch.tensor(agg.astype(np.int64), device=device),
                torch.tensor(svec, dtype=dtype, device=device),
                inv_diag,
                sm,
                float(omega),
                int(na),
            )
        )
        Asp = Ac
    coarse_inv = _coarse_inverse(Asp, dtype, device)
    field_shape = tuple(A.grid_shape) if isinstance(A, StencilOperator) else None
    return AMGPC(tuple(levels), coarse_inv, cycles, field_shape)
