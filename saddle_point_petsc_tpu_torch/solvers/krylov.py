"""Krylov solvers, main-path subset (PyTorch twin of
`saddle_point_petsc_tpu.solvers.krylov`): CG, the pseudo-block CG over k
right-hand sides (`cg_multi`, KSPMatSolve), MINRES, GMRES and FGMRES, and
the fixed-count Chebyshev iteration that smooths the gamg levels.

A vector is a tensor or a tuple of tensors (a KKT vector is `(u, lam)`);
operators and preconditioners are callables from vector to vector.

Each solver is a host loop. Per-iteration scalars stay 0-d tensors on the
vectors' device; the loop syncs once per iteration, fetching the residual
norm (and, where a solver needs them, a few more scalars in the same
transfer) for the convergence test. GMRES's small Hessenberg least-squares
problem runs on the host from that same transfer, as PETSc does.

Convergence follows PETSc's KSPConvergedDefault: converged when
rnorm <= max(rtol * rnorm0, atol), diverged when rnorm > dtol * rnorm0,
where rnorm0 is the norm of the (preconditioned, for left-PC solvers)
right-hand side. CG/MINRES/GMRES track the preconditioned residual norm;
FGMRES (right PC) tracks the true residual norm.

Spans (utils/monitor.py, recorded while a torch profiler runs): each
apply of the operator inside a solver's loop runs under `MatMult`, each
apply of the PC under `PCApply`, and each host sync with the convergence
test it feeds under `KSPConvergedTest`. They sit here, at the call sites:
the solvers take A itself, through which `reduces_over_ranks` finds the
mesh.

Distributed vectors (parallel/dist.py, parallel/dist_csr.py): a
distributed operator declares, leaf by leaf, how its vectors lie over the
ranks (`dist_leaves`): "patch" (this rank's patch of a global grid field),
"rows" (this rank's block of rows of a global vector) or None (replicated,
equal on every rank, as the KKT multipliers); a (k, ...) batch follows its
columns. Each solver (and `precond.estimate_lmax`) enters `distributed`
with its operator's mesh and declaration (`reduces_over_ranks`), the one
place that decides; inside it the reductions `tdot`, `_kdot` and
`_basis_dots` sum the rank-local parts over the ranks with one all_reduce
(the JAX package's psum), never a gather, and add the replicated parts.
Every rank gets the same sums, so every rank takes the same branches. An
operator without a mesh runs with no distribution: no collective and no
extra sync. The distributed operators sum their own products over the
ranks (parallel/dist.py).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch

from saddle_point_petsc_tpu_torch.utils.monitor import span

# -- converged reasons (subset of PETSc KSPConvergedReason codes) -----------
CONVERGED_RTOL = 2
CONVERGED_ATOL = 3
CONVERGED_ITS = 4
DIVERGED_NULL = -2
DIVERGED_ITS = -3
DIVERGED_DTOL = -4
DIVERGED_INDEFINITE_PC = -8
DIVERGED_NANORINF = -9

REASON_NAMES = {
    2: "CONVERGED_RTOL",
    3: "CONVERGED_ATOL",
    4: "CONVERGED_ITS",
    -2: "DIVERGED_NULL",
    -3: "DIVERGED_ITS",
    -4: "DIVERGED_DTOL",
    -8: "DIVERGED_INDEFINITE_PC",
    -9: "DIVERGED_NANORINF",
}


# -- vector algebra over tensors and tuples of tensors ----------------------

def _map(fn, *vs):
    if isinstance(vs[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*vs))
    return fn(*vs)


def _leaves(v):
    return v if isinstance(v, tuple) else (v,)


@dataclasses.dataclass(frozen=True)
class Distribution:
    """How the vectors of the solve in progress lie over the ranks of
    `mesh` (a parallel.mesh.ProcessMesh): per leaf, "patch", "rows" or
    None (see the module docstring)."""

    mesh: Any
    leaves: tuple


# the Distribution of the solve in progress, or None
_DIST = contextvars.ContextVar("krylov_distribution", default=None)


def distribution() -> Optional[Distribution]:
    """The Distribution that the reductions use here, or None."""
    return _DIST.get()


@contextlib.contextmanager
def distributed(mesh, leaves=("patch",)):
    """Within the block, reductions sum the rank-local leaves over the
    ranks of `mesh`; `leaves` declares each leaf's layout ("patch", "rows"
    or None = replicated). mesh None: no distribution in the block."""
    token = _DIST.set(None if mesh is None else Distribution(mesh, tuple(leaves)))
    try:
        yield
    finally:
        _DIST.reset(token)


def reduces_over_ranks(fn):
    """Run fn(A, ...) inside `distributed(mesh, A.dist_leaves)` of its
    operator A (a distributed operator, or a bound method of one such as
    `matmat_field`); an operator without a mesh runs with no distribution.
    Every solver, `precond.estimate_lmax` and the refinement loops enter
    the context here, and nowhere else."""
    @functools.wraps(fn)
    def run(A, *args, **kwargs):
        op = getattr(A, "__self__", A)
        mesh = getattr(op, "mesh", None)
        with distributed(mesh, op.dist_leaves if mesh is not None else ()):
            return fn(A, *args, **kwargs)

    return run


def _sum_leaves(dots):
    """Sum per-leaf partial dots: the rank-local parts summed over the
    ranks by one all_reduce (in place on their fresh sum), then the
    replicated parts added."""
    d = _DIST.get()
    kinds = (None,) * len(dots) if d is None else d.leaves
    local = rep = None
    for dot, kind in zip(dots, kinds, strict=True):
        if kind is not None:
            local = dot if local is None else local + dot
        else:
            rep = dot if rep is None else rep + dot
    if local is not None:
        local = d.mesh.all_reduce(local)
    if rep is None:
        return local
    return rep if local is None else local + rep


def tdot(x, y):
    """Inner product over all leaves, as a 0-d tensor."""
    return _sum_leaves([torch.dot(a.reshape(-1), b.reshape(-1)) for a, b in zip(_leaves(x), _leaves(y))])


def tnorm(x):
    return torch.sqrt(tdot(x, x))


def taxpy(a, x, y):
    """y + a*x leaf by leaf."""
    return _map(lambda xi, yi: yi + a * xi, x, y)


def tscale(a, x):
    return _map(lambda xi: a * xi, x)


def tsub(x, y):
    return _map(torch.sub, x, y)


def tadd(x, y):
    return _map(torch.add, x, y)


def tzeros_like(x):
    return _map(torch.zeros_like, x)


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    x: Any
    iterations: int  # cg_multi: the slowest column's
    rnorm: float  # final residual norm (per solver's norm convention); cg_multi: (k,)
    rnorm0: float  # cg_multi: (k,)
    history: torch.Tensor  # (maxiter+1,) float64 on the CPU, padded with -1; cg_multi: (maxiter+1, k)
    converged_reason: int  # cg_multi: (k,) int64 tensor

    @property
    def converged(self):
        return self.converged_reason > 0

    def reason_name(self):
        return REASON_NAMES.get(int(self.converged_reason), "UNKNOWN")


def _identity(x):
    return x


def _matmult(A, x):
    with span("MatMult"):
        return A(x)


def _pcapply(M, r):
    with span("PCApply"):
        return M(r)


def _check_convergence(rnorm, rnorm0, rtol, atol, dtol, it, maxiter):
    """PETSc KSPConvergedDefault logic on host floats -> (done, reason).

    A non-finite residual norm ends the loop at once (DIVERGED_NANORINF)."""
    if not math.isfinite(rnorm):
        return True, DIVERGED_NANORINF
    if rnorm <= atol:
        return True, CONVERGED_ATOL
    if rnorm <= rtol * rnorm0:
        return True, CONVERGED_RTOL
    if rnorm > dtol * rnorm0:
        return True, DIVERGED_DTOL
    if it >= maxiter:
        return True, DIVERGED_ITS
    return False, 0


def _monitor_print(monitor, it, rnorm):
    if monitor:
        print(f"{it:>5} KSP Residual norm {rnorm:.12e}", flush=True)


def _result(x, history, maxiter, bnorm, reason):
    it = len(history) - 1
    hist = torch.full((maxiter + 1,), -1.0, dtype=torch.float64)
    hist[: it + 1] = torch.tensor(history, dtype=torch.float64)
    return KrylovResult(x, it, history[-1], bnorm, hist, reason)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

@reduces_over_ranks
def cg(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
    norm_type="preconditioned",
    monitor=False,
):
    """Preconditioned conjugate gradients (left PC, PETSc KSPCG semantics).

    M must be SPD. norm_type: "preconditioned" (PETSc default),
    "unpreconditioned" or "natural".
    """
    if norm_type not in ("preconditioned", "unpreconditioned", "natural"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0

    def norm_of(r, z, rzdot):
        if norm_type == "preconditioned":
            return tnorm(z)
        if norm_type == "unpreconditioned":
            return tnorm(r)
        return torch.sqrt(torch.abs(rzdot))

    r = tsub(b, _matmult(A, x))
    z = _pcapply(M, r)
    rz = tdot(r, z)
    zb = _pcapply(M, b)
    norms = torch.stack([norm_of(b, zb, tdot(b, zb)), norm_of(r, z, rz)])
    with span("KSPConvergedTest"):
        bnorm, rnorm = norms.tolist()
    history = [rnorm]
    _monitor_print(monitor, 0, rnorm)
    done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, 0, maxiter)
    p = z
    while not done:
        w = _matmult(A, p)
        pw = tdot(p, w)
        alpha = rz / pw
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, w, r)
        z = _pcapply(M, r)
        rz_new = tdot(r, z)
        beta = rz_new / rz
        p = taxpy(beta, p, z)
        rz = rz_new
        stats = torch.stack([norm_of(r, z, rz_new), pw])
        with span("KSPConvergedTest"):
            rnorm, pw_h = stats.tolist()
            history.append(rnorm)
            it = len(history) - 1
            _monitor_print(monitor, it, rnorm)
            done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, it, maxiter)
            if pw_h <= 0.0:  # indefinite operator guard
                done, reason = True, DIVERGED_NULL
    return _result(x, history, maxiter, bnorm, reason)


def _kdot(x, y):
    """Per-column dot over a leading-k batch: (k, ...) -> (k,)."""
    return _sum_leaves([torch.sum((x * y).reshape(x.shape[0], -1), dim=1)])


def _kax(a, x, y):
    """y + a[k] * x with a (k,) broadcast over trailing dims."""
    return y + a.reshape((-1,) + (1,) * (x.ndim - 1)) * x


@reduces_over_ranks
def cg_multi(
    A: Callable,
    B,
    M: Optional[Callable] = None,
    x0=None,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
):
    """Pseudo-block CG over k right-hand sides, PETSc KSPMatSolve semantics.

    A and M are batched callables mapping (k, ...) -> (k, ...), such as the
    operator's SpMM (`StencilOperator.matmat_field`, kernel B2), so the
    operator is streamed once per iteration for all k columns. Each column
    runs its own CG recurrence (its own alpha and beta, frozen at 0 once the
    column is done) on the preconditioned residual norm. A column converges
    when rnorm <= max(rtol * bnorm, atol) (CONVERGED_RTOL) and diverges on
    pw <= 0, a non-finite norm or rnorm > dtol * bnorm (DIVERGED_NULL) or at
    maxiter (DIVERGED_ITS); the loop stops when every column is done. The
    test runs on the device, in the vectors' dtype, as the JAX package's;
    the loop fetches one small (3, k) tensor (norms, done flags, reasons)
    per iteration.

    Returns a KrylovResult whose x is the (k, ...) solution batch, whose
    rnorm, rnorm0 (bnorm) and converged_reason are (k,) CPU tensors, whose
    history is (maxiter+1, k) float64 padded with -1, and whose
    `iterations` is the slowest column's count.
    """
    M = M or _identity
    X = torch.zeros_like(B) if x0 is None else x0
    R = B - _matmult(A, X)
    Z = _pcapply(M, R)
    rz = _kdot(R, Z)
    Zb = _pcapply(M, B)
    bnorm = torch.sqrt(_kdot(Zb, Zb))
    rnorm = torch.sqrt(_kdot(Z, Z))
    thresh = torch.clamp_min(rtol * bnorm, atol)
    done = rnorm <= thresh
    reason = torch.where(done, CONVERGED_RTOL, 0)

    def fetch():
        stats = torch.stack([t.to(torch.float64) for t in (rnorm, done, reason)])
        with span("KSPConvergedTest"):
            return stats.tolist()

    rn_h, done_h, reason_h = fetch()
    history = [rn_h]
    P = Z
    it = 0
    while not all(done_h):
        W = _matmult(A, P)
        pw = _kdot(P, W)
        alpha = torch.where(done, 0.0, rz / torch.where(pw == 0, 1.0, pw))
        X = _kax(alpha, P, X)
        R = _kax(-alpha, W, R)
        Z = _pcapply(M, R)
        rz_new = _kdot(R, Z)
        beta = torch.where(done, 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
        P = _kax(beta, P, Z)
        rz = rz_new
        it += 1
        rnorm = torch.sqrt(_kdot(Z, Z))
        conv = rnorm <= thresh
        div = (rnorm > dtol * bnorm) | ~torch.isfinite(rnorm) | (pw <= 0.0)
        newly = ~done
        reason = torch.where(
            newly & conv, CONVERGED_RTOL, torch.where(newly & div, DIVERGED_NULL, reason)
        )
        done = done | conv | div | (it >= maxiter)
        reason = torch.where(done & (reason == 0), DIVERGED_ITS, reason)
        rn_h, done_h, reason_h = fetch()
        history.append(rn_h)
    k = B.shape[0]
    hist = torch.full((maxiter + 1, k), -1.0, dtype=torch.float64)
    rows = min(it, maxiter) + 1
    hist[:rows] = torch.tensor(history[:rows], dtype=torch.float64)
    return KrylovResult(
        X,
        it,
        torch.tensor(rn_h, dtype=torch.float64),
        bnorm.to("cpu", torch.float64),
        hist,
        torch.tensor(reason_h, dtype=torch.int64),
    )


# ---------------------------------------------------------------------------
# MINRES
# ---------------------------------------------------------------------------

@reduces_over_ranks
def minres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
    monitor=False,
):
    """Preconditioned MINRES (Paige-Saunders) for symmetric (indefinite) A.

    M must be SPD. Tracks the preconditioned residual norm phi-bar (PETSc
    KSPMINRES default norm); the solver of the KKT system [[A,B^T],[B,0]].
    """
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0

    r2 = tsub(b, _matmult(A, x))
    y = _pcapply(M, r2)
    beta1sq = tdot(r2, y)
    beta1 = torch.sqrt(torch.clamp_min(beta1sq, 0.0))
    bnorm_t = torch.sqrt(torch.clamp_min(tdot(b, _pcapply(M, b)), 0.0))
    stats = torch.stack([beta1, bnorm_t, beta1sq])
    with span("KSPConvergedTest"):
        rnorm, bnorm, beta1sq_h = stats.tolist()
        history = [rnorm]
        _monitor_print(monitor, 0, rnorm)
        done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, 0, maxiter)
        if beta1sq_h < 0.0:
            done, reason = True, DIVERGED_INDEFINITE_PC

    eps = torch.finfo(beta1.dtype).eps
    zero = tzeros_like(b)
    r1 = r2
    w = w1 = w2 = zero
    oldb = torch.zeros_like(beta1)
    beta = beta1
    dbar = torch.zeros_like(beta1)
    epsln = torch.zeros_like(beta1)
    cs = torch.full_like(beta1, -1.0)
    sn = torch.zeros_like(beta1)
    phibar = beta1
    it = 0
    while not done:
        it += 1
        v = tscale(1.0 / beta, y)
        y = _matmult(A, v)
        if it >= 2:
            y = taxpy(-(beta / oldb), r1, y)
        alfa = tdot(v, y)
        y = taxpy(-(alfa / beta), r2, y)
        r1, r2 = r2, y
        y = _pcapply(M, r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp_min(tdot(r2, y), 0.0))
        # Givens QR of the tridiagonal
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp_min(torch.sqrt(gbar**2 + beta**2), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = tscale(1.0 / gamma, tsub(v, tadd(tscale(oldeps, w1), tscale(delta, w2))))
        x = taxpy(phi, w, x)
        with span("KSPConvergedTest"):
            rnorm = torch.abs(phibar).item()
            history.append(rnorm)
            _monitor_print(monitor, it, rnorm)
            done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, it, maxiter)
    return _result(x, history, maxiter, bnorm, reason)


# ---------------------------------------------------------------------------
# GMRES / FGMRES
# ---------------------------------------------------------------------------

def _basis_dots(V, k, w):
    """<V_i, w> for the first k basis vectors in one product per leaf, (k,)."""
    return _sum_leaves([buf[:k] @ leaf.reshape(-1) for buf, leaf in zip(V, _leaves(w))])


def _basis_axpy(V, coefs, w):
    """w + sum_i coefs[i] * V_i for len(coefs) leading basis vectors."""
    k = coefs.shape[0]
    leaves = tuple(
        leaf + (coefs @ buf[:k]).reshape(leaf.shape) for buf, leaf in zip(V, _leaves(w))
    )
    return leaves if isinstance(w, tuple) else leaves[0]


def _basis_set(V, j, v):
    for buf, leaf in zip(V, _leaves(v)):
        buf[j] = leaf.reshape(-1)  # in place: the basis buffers are owned by the cycle


def _basis_get(V, j, template):
    leaves = tuple(buf[j].reshape(t.shape) for buf, t in zip(V, _leaves(template)))
    return leaves if isinstance(template, tuple) else leaves[0]


def _gmres_impl(A, b, M, x0, rtol, atol, dtol, maxiter, restart, monitor, flexible):
    """Shared GMRES/FGMRES implementation.

    flexible=False: left-preconditioned GMRES; Arnoldi runs on M∘A; the
      tracked norm is the preconditioned residual (PETSc KSPGMRES default).
    flexible=True: right-preconditioned FGMRES; stores Z_j = M(v_j); the
      tracked norm is the true residual (PETSc KSPFGMRES).
    CGS2 orthogonalization: two blocks of dots per inner iteration. The
    Givens rotations and the back-substitution run on the host in float64
    on the Hessenberg column fetched once per iteration.
    """
    m = restart
    M = M or _identity
    ref = _leaves(b)[0]
    rdtype, device = ref.dtype, ref.device
    eps = torch.finfo(rdtype).eps

    def pre_res(x):
        r = tsub(b, _matmult(A, x))
        return r if flexible else _pcapply(M, r)

    bnorm_t = tnorm(b if flexible else _pcapply(M, b))
    x = x0
    rnorm0_t = tnorm(pre_res(x))
    with span("KSPConvergedTest"):
        bnorm, rnorm0 = bnorm_t.item(), rnorm0_t.item()
        history = [rnorm0]
        _monitor_print(monitor, 0, rnorm0)
        done, reason = _check_convergence(rnorm0, bnorm, rtol, atol, dtol, 0, maxiter)
    while not done:  # one restart cycle of <= m Arnoldi steps
        r = pre_res(x)
        beta_t = tnorm(r)
        with span("KSPConvergedTest"):
            beta = beta_t.item()
        V = [torch.zeros((m + 1, leaf.numel()), dtype=rdtype, device=device) for leaf in _leaves(b)]
        Z = [torch.zeros((m, leaf.numel()), dtype=rdtype, device=device) for leaf in _leaves(b)] if flexible else None
        # guard the division only against exact zero: an absolute floor
        # would break scale invariance for tiny right-hand sides
        _basis_set(V, 0, tscale(1.0 / (beta_t if beta > 0 else 1.0), r))
        H = [[0.0] * m for _ in range(m + 1)]
        cs, sn = [0.0] * m, [0.0] * m
        g = [0.0] * (m + 1)
        g[0] = beta
        j = 0
        while not done and j < m:
            v = _basis_get(V, j, b)
            if flexible:
                z = _pcapply(M, v)
                _basis_set(Z, j, z)
                w = _matmult(A, z)
            else:
                w = _pcapply(M, _matmult(A, v))
            # CGS2 against V[0..j]
            h1 = _basis_dots(V, j + 1, w)
            w = _basis_axpy(V, -h1, w)
            h2 = _basis_dots(V, j + 1, w)
            w = _basis_axpy(V, -h2, w)
            hnew_t = tnorm(w)
            _basis_set(V, j + 1, tscale(1.0 / torch.where(hnew_t > 0, hnew_t, 1.0), w))
            hcol_t = torch.cat([h1 + h2, hnew_t[None]])
            with span("KSPConvergedTest"):
                *h, hnew = hcol_t.tolist()
                col = h + [hnew] + [0.0] * (m - j - 1)
                for i in range(j):  # previous Givens rotations
                    hi = cs[i] * col[i] + sn[i] * col[i + 1]
                    col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
                    col[i] = hi
                denom = math.sqrt(col[j] ** 2 + col[j + 1] ** 2)
                denom = denom if denom > 0 else 1.0
                cs[j], sn[j] = col[j] / denom, col[j + 1] / denom
                col[j], col[j + 1] = denom, 0.0
                g[j], g[j + 1] = cs[j] * g[j], -sn[j] * g[j]
                for i in range(m + 1):
                    H[i][j] = col[i]
                rnorm = abs(g[j + 1])
                history.append(rnorm)
                it = len(history) - 1
                _monitor_print(monitor, it, rnorm)
                done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, it, maxiter)
                # happy breakdown, judged relative to the column magnitude
                hcol = math.sqrt(sum(t * t for t in h) + hnew * hnew)
                done = done or hnew <= eps * 100.0 * hcol
            j += 1
        # back-substitution on the j x j triangular system
        y = [0.0] * j
        for i in range(j - 1, -1, -1):
            num = g[i] - sum(H[i][k] * y[k] for k in range(i + 1, j))
            hii = H[i][i] if abs(H[i][i]) > 0 else 1.0
            y[i] = num / hii
        coefs = torch.tensor(y, dtype=rdtype, device=device)
        x = _basis_axpy(Z if flexible else V, coefs, x)
    return _result(x, history, maxiter, bnorm, reason)


@reduces_over_ranks
def gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
    restart=30,
    monitor=False,
):
    """Left-preconditioned restarted GMRES (PETSc KSPGMRES semantics)."""
    x0 = tzeros_like(b) if x0 is None else x0
    return _gmres_impl(A, b, M, x0, rtol, atol, dtol, maxiter, restart, monitor, False)


@reduces_over_ranks
def fgmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
    restart=30,
    monitor=False,
):
    """Flexible (right-preconditioned) restarted GMRES: the preconditioner
    may change between iterations. PETSc KSPFGMRES semantics; tracks the
    true residual norm."""
    x0 = tzeros_like(b) if x0 is None else x0
    return _gmres_impl(A, b, M, x0, rtol, atol, dtol, maxiter, restart, monitor, True)


# ---------------------------------------------------------------------------
# Chebyshev (fixed count, the AMG smoother)
# ---------------------------------------------------------------------------

def chebyshev_iterate(A: Callable, b, M: Optional[Callable] = None, x0=None,
                      lmin=0.1, lmax=1.1, maxiter=10):
    """x after `maxiter` Chebyshev semi-iterations on bounds [lmin, lmax] of
    M A (three-term recurrence, no inner products, no host sync). The
    coefficients are host floats."""
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    z = M(tsub(b, A(x0)))
    rho = 1.0 / sigma1
    d = tscale(1.0 / theta, z)
    x = tadd(x0, d)
    for _ in range(1, maxiter):
        z = M(tsub(b, A(x)))
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = tadd(tscale(rho_new * rho, d), tscale(2.0 * rho_new / delta, z))
        x = tadd(x, d)
        rho = rho_new
    return x


@reduces_over_ranks
def chebyshev_fixed(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    lmin=0.1,
    lmax=1.1,
    maxiter=10,
):
    """Fixed-count Chebyshev semi-iteration on bounds [lmin, lmax] of M A,
    as a KrylovResult with the final true residual norm (CONVERGED_ITS).
    ChebyshevPC applies `chebyshev_iterate`, which skips that residual."""
    x = chebyshev_iterate(A, b, M, x0, lmin, lmax, maxiter)
    rnorm, bnorm = torch.stack([tnorm(tsub(b, A(x))), tnorm(b)]).tolist()
    hist = torch.full((maxiter + 1,), -1.0, dtype=torch.float64)
    hist[0] = rnorm
    return KrylovResult(x, maxiter, rnorm, bnorm, hist, CONVERGED_ITS)


# ---------------------------------------------------------------------------
# Richardson / Chebyshev KSP / BiCGStab
# ---------------------------------------------------------------------------

@reduces_over_ranks
def richardson(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    scale=1.0,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10,
    monitor=False,
):
    """Damped Richardson iteration x += scale * M(b - A x), exactly
    `maxiter` sweeps, as the JAX package runs it: there is no test inside
    the loop, the reason judges the last residual. history[i + 1] is the
    norm of the residual that sweep i corrected (history[1] ==
    history[0]). The norms stay on the device until the loop ends; the
    monitor flag is accepted and, as in the JAX package, prints nothing."""
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0
    norms = [tnorm(tsub(b, _matmult(A, x)))]
    for _ in range(maxiter):
        r = tsub(b, _matmult(A, x))
        x = taxpy(scale, _pcapply(M, r), x)
        norms.append(tnorm(r))
    stats = torch.stack([tnorm(b)] + norms)
    with span("KSPConvergedTest"):
        bnorm, *history = stats.tolist()
        _, reason = _check_convergence(history[-1], bnorm, rtol, atol, dtol, maxiter, maxiter)
    return _result(x, history, maxiter, bnorm, reason)


@reduces_over_ranks
def chebyshev(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    lmin=0.1,
    lmax=1.1,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
    monitor=False,
):
    """Chebyshev iteration on bounds [lmin, lmax] of M A with PETSc's
    convergence test on the true residual norm every iteration
    (KSPCHEBYSHEV semantics): it stops at rtol instead of running maxiter
    sweeps."""
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    r = tsub(b, _matmult(A, x))
    stats = torch.stack([tnorm(r), tnorm(b)])
    with span("KSPConvergedTest"):
        rnorm, bnorm = stats.tolist()
        history = [rnorm]
        _monitor_print(monitor, 0, rnorm)
        done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, 0, maxiter)
    d, rho = None, 1.0
    while not done:
        z = _pcapply(M, r)
        if d is None:  # first step: d = z / theta
            rho = 1.0 / sigma1
            d = tscale(1.0 / theta, z)
        else:  # three-term recurrence
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = tadd(tscale(rho_new * rho, d), tscale(2.0 * rho_new / delta, z))
            rho = rho_new
        x = tadd(x, d)
        r = tsub(b, _matmult(A, x))
        rnorm_t = tnorm(r)
        with span("KSPConvergedTest"):
            rnorm = rnorm_t.item()
            history.append(rnorm)
            it = len(history) - 1
            _monitor_print(monitor, it, rnorm)
            done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, it, maxiter)
    return _result(x, history, maxiter, bnorm, reason)


@reduces_over_ranks
def bcgs(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    rtol=1e-5,
    atol=1e-50,
    dtol=1e5,
    maxiter=10000,
    monitor=False,
):
    """Preconditioned BiCGStab (PETSc KSPBCGS, right-preconditioned form)
    for nonsymmetric systems: two matvecs and two PC applies per
    iteration, tracking the true residual norm. A zero denominator is
    replaced by the dtype's smallest normal number (`finfo.tiny`), as in
    the JAX package; the scalars stay 0-d tensors on the device."""
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0
    r = tsub(b, _matmult(A, x))
    r0hat = r
    stats = torch.stack([tnorm(r), tnorm(b)])
    with span("KSPConvergedTest"):
        rnorm, bnorm = stats.tolist()
        history = [rnorm]
        _monitor_print(monitor, 0, rnorm)
        done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, 0, maxiter)
    tiny = torch.finfo(_leaves(b)[0].dtype).tiny

    def safe(t):
        return torch.where(t == 0, tiny, t)

    p = v = tzeros_like(b)
    one = torch.ones((), dtype=_leaves(b)[0].dtype, device=_leaves(b)[0].device)
    rho = alpha = omega = one
    while not done:
        rho_new = tdot(r0hat, r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p = taxpy(beta, taxpy(-omega, v, p), r)
        phat = _pcapply(M, p)
        v = _matmult(A, phat)
        alpha = rho_new / safe(tdot(r0hat, v))
        sres = taxpy(-alpha, v, r)
        shat = _pcapply(M, sres)
        t = _matmult(A, shat)
        omega = tdot(t, sres) / safe(tdot(t, t))
        x = taxpy(omega, shat, taxpy(alpha, phat, x))
        r = taxpy(-omega, t, sres)
        rho = rho_new
        rnorm_t = tnorm(r)
        with span("KSPConvergedTest"):
            rnorm = rnorm_t.item()
            history.append(rnorm)
            it = len(history) - 1
            _monitor_print(monitor, it, rnorm)
            done, reason = _check_convergence(rnorm, bnorm, rtol, atol, dtol, it, maxiter)
    return _result(x, history, maxiter, bnorm, reason)


SOLVERS = {
    "cg": cg,
    "minres": minres,
    "gmres": gmres,
    "fgmres": fgmres,
    "bcgs": bcgs,
    "richardson": richardson,
    "chebyshev": chebyshev,
}
