"""Algebraic multigrid, smoothed aggregation (PyTorch twin of
`saddle_point_petsc_tpu.solvers.amg`; PETSc -pc_type gamg), serial and
over row-partitioned DistAIJs.

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
MINRES): solvers/multigrid.py's one `cycle`, under its level spans
(`MGSmooth Lk`, `MGResid Lk`, `MGRestrict Lk`, `MGInterp Lk`).

The distributed hierarchy (`dist_amg_pc`, PCGAMG on MATMPIAIJ) stores each
level, P and R = P^T as DistAIJs (parallel/dist_csr.py) and applies them
with the DistAIJ matvec. Its setup is either the serial pipeline on the
global matrix, every rank keeping its rows ("global"), or a level at a
time from each rank's own rows ("stream", -pc_gamg_setup stream). gamg
refuses a distributed stencil operator, as in the JAX package (`_to_scipy`
raises TypeError). The stream set-up runs each step of a level under a
span named with the level (`GAMGRho`, `GAMGAggregate`, `GAMGProlong`,
`GAMGGalerkin`, `GAMGLevelBuild` `Lk`) and the coarsest level's gather
and inverse under `GAMGCoarseSetUp`, and counts what it built
(`GAMG.levels`, `GAMG.rows`, `GAMG.nnz`; utils/monitor.py).
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
from saddle_point_petsc_tpu_torch.parallel import dist_csr
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.solvers import precond
from saddle_point_petsc_tpu_torch.solvers.multigrid import LevelSpans, cycle
from saddle_point_petsc_tpu_torch.utils import monitor


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
    smoother: Any  # precond.ChebyshevPC, before and after
    omega: float
    n_c: int
    spans: LevelSpans = LevelSpans.of(0)

    @property
    def post(self):
        return self.smoother

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
        # solve is exact, applied directly
        z = cycle(self.levels, self._coarse, r, w=self.cycles >= 2)
        if field:
            z = flat_to_field(z, *self.field_shape)
        return z

    def _coarse(self, r):
        return self.coarse_inv @ r


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


def _coarsen(Asp, theta):
    """One smoothed-aggregation coarsening of the f64 host matrix Asp: None
    when no coarsening is possible (e.g. a diagonal matrix), else (agg,
    na, svec, d, rho, omega, P, Ac): the aggregates and their count, the
    tentative prolongator's column scaling 1/sqrt(|aggregate|), the
    diagonal (zeros as 1), rho(D^-1 A), omega = 4/3 / rho, the smoothed
    prolongator P = (I - omega D^-1 A) P0 and the Galerkin product
    P^T A P."""
    import scipy.sparse as sps

    n = Asp.shape[0]
    agg, na = _aggregate(_strength_graph(Asp, theta))
    if na >= n:
        return None
    # tentative piecewise-constant prolongator, columns normalized
    sizes = np.bincount(agg, minlength=na).astype(np.float64)
    svec = 1.0 / np.sqrt(sizes[agg])
    P0 = sps.csr_matrix((svec, (np.arange(n), agg)), shape=(n, na))
    rho = _rho_dinv_a(Asp)
    omega = 4.0 / (3.0 * rho)
    d = Asp.diagonal()
    d = np.where(d == 0.0, 1.0, d)
    P = (P0 - omega * (sps.diags(1.0 / d) @ (Asp @ P0))).tocsr()
    Ac = (P.T @ Asp @ P).tocsr()
    Ac.eliminate_zeros()
    return agg, na, svec, d, rho, omega, P, Ac


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
        step = _coarsen(Asp, theta)
        if step is None:
            break
        agg, na, svec, d, rho, omega, _, Ac = step
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
                LevelSpans.of(len(levels)),
            )
        )
        Asp = Ac
    coarse_inv = _coarse_inverse(Asp, dtype, device)
    field_shape = tuple(A.grid_shape) if isinstance(A, StencilOperator) else None
    return AMGPC(tuple(levels), coarse_inv, cycles, field_shape)


# ---------------------------------------------------------------------------
# Distributed AMG: gamg over DistAIJ (MATMPIAIJ)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistAMGLevel:
    """One level over row-partitioned DistAIJs, this rank's rows of each."""

    A: Any  # DistAIJ, the level operator
    P: Any  # DistAIJ (n_f, n_c): coarse -> fine, columns padded to the next level's n_pad
    R: Any  # DistAIJ (n_c, n_f) = P^T: fine -> coarse, columns padded to this level's n_pad
    smoother: Any  # precond.ChebyshevPC over A, before and after
    n_pad_c: int  # the next level's padded length
    spans: LevelSpans = LevelSpans.of(0)

    @property
    def post(self):
        return self.smoother

    # R and P are rectangular: restriction lands in the coarse padded
    # length and prolongation consumes it, each O(P nnz)
    def restrict(self, r):
        return self.R.matvec(r)

    def prolong(self, zc):
        return self.P.matvec(zc)


@dataclasses.dataclass(frozen=True)
class DistAMGPC:
    """Smoothed-aggregation AMG over DistAIJ operators (PETSc PCGAMG on a
    parallel MATAIJ); vectors are this rank's rows. Every level matvec,
    restriction and prolongation is a DistAIJ matvec: B3 or B5 on the
    local block, and where any rank has ghosts one all_to_all and B5 on
    them. The smoothers are inner-product free. The coarse solve gathers
    the coarse vector (one all_gather; none in a world of one), applies
    the replicated inverse and keeps this rank's rows."""

    levels: Tuple[DistAMGLevel, ...]
    coarse_inv: Any  # (n_pad, n_pad) inverse of the coarsest level, pad rows identity: dense or SplitCoarseInverse
    mesh: Any
    cycles: int = 1  # PETSc PCMGSetCycleType: 1 = V, 2 = W

    def __call__(self, r):
        # an empty hierarchy: the coarse solve is exact, applied directly
        return cycle(self.levels, self._coarse, r, w=self.cycles >= 2)

    def _coarse(self, r):
        lo = self.mesh.rank * r.shape[0]
        return (self.coarse_inv @ pmesh.gather_rows(r, self.mesh))[lo : lo + r.shape[0]]


def _dist_level(A, P, R, inv_diag, rho, smooth_its, nxt, k=0):
    """Level k, a DistAMGLevel with its Chebyshev(Jacobi) smoother on
    [rho/4, 1.1 rho]; inv_diag is this rank's (n_loc,) host rows of D^-1."""
    assert P.n_pad_c == nxt.n_pad and R.n_pad_c == A.n_pad, "transfer paddings disagree with the levels'"
    inner = precond.JacobiPC(torch.tensor(inv_diag, dtype=A.diag_vals_t.dtype, device=A.mesh.device))
    sm = precond.ChebyshevPC(A, inner, lmin=rho / 4.0, lmax=1.1 * rho, iters=smooth_its)
    return DistAMGLevel(A, P, R, sm, nxt.n_pad, LevelSpans.of(k))


def _padded_coarse_inverse(Asp, n_pad, dtype, device):
    """`_coarse_inverse` of the coarsest level with its pad rows the
    identity, as the JAX package's np.eye(n_pad)."""
    inv = _coarse_inverse(Asp.astype(np.float64), dtype, device)
    n = Asp.shape[0]
    if isinstance(inv, SplitCoarseInverse):
        pad = torch.arange(n, n_pad, device=device)
        return dataclasses.replace(inv, iso=torch.cat([inv.iso, pad]),
                                   iso_inv=torch.cat([inv.iso_inv, inv.iso_inv.new_ones(n_pad - n)]))
    dense = torch.eye(n_pad, dtype=dtype, device=device)
    dense[:n, :n] = inv  # in place: dense is the fresh identity made above
    return dense


def _rho_dinv_a_device(A, d, iters=15):
    """Power-iteration estimate of rho(D^-1 A) with the DistAIJ matvec, d
    this rank's (n_loc,) host diagonal: no host matrix. lam stays on the
    device and is read once, at the end; each step's norm is one
    all_reduce (none in a world of one).

    The start vector is the JAX package's, np.random.default_rng(0) over
    the global n: each rank draws all of it and keeps its rows. That costs
    O(n) host time a rank, not O(nnz), and keeps rho equal to the JAX
    package's."""
    mesh, dtype = A.mesh, A.diag_vals_t.dtype
    np_dtype = dist_csr._np_dtype(dtype)
    dinv = torch.tensor(1.0 / d, dtype=dtype, device=mesh.device)
    v = dist_csr.pad_vector(np.random.default_rng(0).standard_normal(A.shape[0]).astype(np_dtype), A.n_pad, mesh)
    for _ in range(iters):
        w = dinv * A.matvec(v)
        lam = torch.sqrt(mesh.all_reduce(torch.dot(w, w)))
        v = w / lam
    return max(lam.item(), 1e-30)


def _count_level(a, rows):
    """One level of the hierarchy in the counter table: `GAMG.levels`, and
    the first `rows` rows of its operator's CSR `a`, this rank's true rows,
    and their entries (`GAMG.rows`, `GAMG.nnz`)."""
    monitor.count("GAMG.levels")
    monitor.count("GAMG.rows", rows)
    monitor.count("GAMG.nnz", int(a.indptr[rows]))


def _dist_amg_stream_level(A, theta, smooth_its, k=0):
    """One SA-AMG level from this rank's rows alone: no rank holds the
    global matrix, and every host step is O(local nnz).

    rho(D^-1 A) comes from the DistAIJ power iteration. Aggregation runs
    on this rank's diag block, so aggregates never cross ranks (as in the
    JAX package; PCGAMG's do). The aggregates are numbered from one
    all_reduce of the counts; P0's aggregate and weight at the ghost
    columns come through A's own ghost scatter; the rows of P = (I -
    omega D^-1 A) P0 at the ghost columns from their owners
    (`fetch_rows`); the Galerkin contributions P_s^T (A_s P) and R's
    triplets (P's, transposed) go to their row owners
    (`ship_triplets`), and each rank builds its rows of P, R and Ac
    (`dist_aij_from_rows`). Each step runs under its span: `GAMGRho Lk`,
    `GAMGAggregate Lk`, `GAMGProlong Lk`, `GAMGGalerkin Lk`,
    `GAMGLevelBuild Lk`.

    Returns (level k, next level's DistAIJ, its f64 host rows, this rank's
    global aggregate ids), or None when the ranks coarsen nothing."""
    import scipy.sparse as sps

    mesh, dtype = A.mesh, A.diag_vals_t.dtype
    np_dtype = dist_csr._np_dtype(dtype)
    rank, n, n_loc = mesh.rank, A.shape[0], A.n_loc
    lo = rank * n_loc
    m_s = max(min(lo + n_loc, n) - lo, 0)  # this rank's true rows
    with monitor.span(f"GAMGRho L{k}"):
        d = dist_csr._host(A.diagonal()).astype(np.float64)
        d = np.where(d == 0.0, 1.0, d)
        rho = _rho_dinv_a_device(A, d)
    omega = 4.0 / (3.0 * rho)

    with monitor.span(f"GAMGAggregate L{k}"):
        blk = A.to_scipy_rows()[:m_s]
        agg, na = (0, 0) if m_s == 0 else _aggregate(_strength_graph(blk[:, lo : lo + m_s].tocsr(), theta))
        counts = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
        counts[rank] = na
        counts = dist_csr._host(mesh.all_reduce(counts))
        na_tot = int(counts.sum())
    if na_tot == 0 or na_tot >= n:
        return None
    _count_level(blk, m_s)

    with monitor.span(f"GAMGProlong L{k}"):
        own = np.full(n_loc, -1, np.int64)  # P0's column at each row of this rank
        own[:m_s] = agg + counts[:rank].sum()
        s_own = np.zeros(n_loc)
        s_own[:m_s] = 1.0 / np.sqrt(np.bincount(agg, minlength=na).astype(np.float64)[agg]) if m_s else 0.0

        # A_s P0, P0's rows at the ghost columns coming through A's scatter;
        # every ghost slot (padding too) holds its ghost_cols column's value
        coo = blk.tocoo()
        col = coo.col.astype(np.int64)
        ghost = col // A.n_loc_c != rank
        pos = col - lo
        if ghost.any():
            uc, first = np.unique(A.ghost_cols, return_index=True)
            pos[ghost] = n_loc + first[np.searchsorted(uc, col[ghost])]
        p0_col = np.concatenate([own, _ghost_values(A, own)])[pos]
        p0_val = np.concatenate([s_own, _ghost_values(A, s_own)])[pos]
        AP0 = sps.csr_matrix((coo.data * p0_val, (coo.row, p0_col)), shape=(m_s, na_tot))
        P0_s = sps.csr_matrix((s_own[:m_s], (np.arange(m_s), own[:m_s])), shape=(m_s, na_tot))
        P_s = (P0_s - omega * (sps.diags(1.0 / d[:m_s]) @ AP0)).tocsr()

        # P's rows at the ghost columns, from their owners
        P_rows = sps.vstack([P_s, sps.csr_matrix((n_loc - m_s, na_tot))]).tocsr()
        need = np.unique(col[ghost])
        P_ghost = dist_csr.fetch_rows(P_rows, need, mesh)

    with monitor.span(f"GAMGGalerkin L{k}"):
        # P_s^T (A_s P), shipped to the row owners; R's rows (P's, transposed)
        cpos = np.where(ghost, m_s + np.searchsorted(need, col), col - lo)
        A_c = sps.csr_matrix((coo.data, (coo.row, cpos)), shape=(m_s, m_s + len(need)))
        contrib = (P_s.T @ (A_c @ sps.vstack([P_s, P_ghost]))).tocoo()
        n_loc_c = -(-na_tot // mesh.size)
        r, c, v = dist_csr.ship_triplets(contrib.row.astype(np.int64), contrib.col.astype(np.int64), contrib.data,
                                         n_loc_c, mesh)
        Ac_rows = sps.csr_matrix((v, (r - rank * n_loc_c, c)), shape=(n_loc_c, na_tot))  # duplicates summed
        Ac_rows.eliminate_zeros()
        pt = P_s.tocoo()
        r, c, v = dist_csr.ship_triplets(pt.col.astype(np.int64), pt.row.astype(np.int64) + lo, pt.data, n_loc_c,
                                         mesh)
        R_rows = sps.csr_matrix((v, (r - rank * n_loc_c, c)), shape=(n_loc_c, n))

    with monitor.span(f"GAMGLevelBuild L{k}"):
        Pd = dist_csr.dist_aij_from_rows(P_rows, na_tot, mesh, dtype=np_dtype, n_rows=n)
        Rd = dist_csr.dist_aij_from_rows(R_rows, n, mesh, dtype=np_dtype, n_rows=na_tot)
        nxt = dist_csr.dist_aij_from_rows(Ac_rows, na_tot, mesh, dtype=np_dtype)
        level = _dist_level(A, Pd, Rd, 1.0 / d, rho, smooth_its, nxt, k)
    return level, nxt, Ac_rows, own[:m_s]


def _ghost_values(A, v):
    """The values at A's ghost slots of the vector whose rows this rank
    holds as v (numpy (n_loc,)): A's own ghost scatter, on the host; empty
    when no rank has ghosts."""
    pending = A._exchange_start(torch.from_numpy(v).to(A.mesh.device))
    return v[:0] if pending is None else dist_csr._host(pending.wait()).copy()


def dist_amg_pc(
    A,
    opts=None,
    a_scipy=None,
    theta=0.08,
    coarse_max=500,
    max_levels=10,
    smooth_its=2,
    cycles=1,
    setup="global",
) -> DistAMGPC:
    """The distributed SA-AMG hierarchy of a DistAIJ (host setup, PCSetUp)
    and its PC on A's device. Options as `amg_pc`, and
    -pc_gamg_setup {global,stream}:

    - setup="global" (default): every rank takes the global matrix
      (`a_scipy`, or `A.to_scipy()`) and runs the serial pipeline
      (`_coarsen`), keeping its rows of P, R = P^T and each Ac
      (`dist_aij_from_scipy`): the serial hierarchy by construction.
    - setup="stream": one level at a time from each rank's own rows
      (`_dist_amg_stream_level`); no rank holds a global matrix but the
      coarsest level's, gathered for the replicated coarse solve (when no
      level is built, only if it fits the dense-solve cap, as in the JAX
      package).

    The coarse solve is dense up to 4096 rows and a SplitCoarseInverse
    above, where the JAX package raises.
    """
    if opts is not None:
        theta = opts.get_float("pc_gamg_threshold", theta)
        coarse_max = opts.get_int("pc_gamg_coarse_eq_limit", coarse_max)
        max_levels = opts.get_int("pc_mg_levels", max_levels)
        cycles = opts.get_int("pc_mg_cycles", cycles)
        smooth_its = opts.get_int("pc_gamg_smooth_its", smooth_its)
        setup = opts.get_str("pc_gamg_setup", setup)

    mesh, dtype = A.mesh, A.diag_vals_t.dtype
    levels, cur = [], A
    if setup == "stream":
        rows = None
        while len(levels) < max_levels - 1 and cur.shape[0] > coarse_max:
            out = _dist_amg_stream_level(cur, theta, smooth_its, len(levels))
            if out is None:
                break
            lvl, cur, rows, _ = out
            levels.append(lvl)
        if rows is None:
            if cur.shape[0] > _COARSE_HARD_CAP:
                raise ValueError(
                    "dist_amg_pc(setup='stream'): aggregation produced no coarsening at "
                    f"{cur.shape[0]} rows (> dense-solve cap {_COARSE_HARD_CAP}); lower "
                    "-pc_gamg_threshold or raise -pc_gamg_coarse_eq_limit"
                )
            rows = cur.to_scipy_rows()
        n = cur.shape[0]
        _count_level(rows, max(min(cur.n_loc, n - mesh.rank * cur.n_loc), 0))
        with monitor.span("GAMGCoarseSetUp"):
            cur_sp = dist_csr.gather_scipy_rows(rows, mesh)[:n, :n]
            coarse_inv = _padded_coarse_inverse(cur_sp, cur.n_pad, dtype, mesh.device)
    else:
        np_dtype = dist_csr._np_dtype(dtype)
        cur_sp = (a_scipy if a_scipy is not None else A.to_scipy()).tocsr().astype(np.float64)
        while len(levels) < max_levels - 1 and cur_sp.shape[0] > coarse_max:
            step = _coarsen(cur_sp, theta)
            if step is None:
                break
            _, _, _, d, rho, _, P, Ac = step
            # rectangular DistAIJ transfers, one copy each: O(P nnz) a transfer
            Pd = dist_csr.dist_aij_from_scipy(P, mesh, dtype=np_dtype)
            Rd = dist_csr.dist_aij_from_scipy(P.T.tocsr(), mesh, dtype=np_dtype)
            nxt = dist_csr.dist_aij_from_scipy(Ac, mesh, dtype=np_dtype)
            ivd = np.ones(cur.n_pad)  # pad rows: identity scaling
            ivd[: len(d)] = 1.0 / d
            levels.append(_dist_level(cur, Pd, Rd, mesh.local_rows(ivd), rho, smooth_its, nxt, len(levels)))
            cur, cur_sp = nxt, Ac
        coarse_inv = _padded_coarse_inverse(cur_sp, cur.n_pad, dtype, mesh.device)
    return DistAMGPC(tuple(levels), coarse_inv, mesh, cycles)
