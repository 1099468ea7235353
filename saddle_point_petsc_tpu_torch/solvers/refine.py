"""Mixed-precision iterative refinement (PyTorch twin of
`saddle_point_petsc_tpu.solvers.refine`).

    x in float64; repeat:
      r   = b - A x          <- float64 residual (the f64 planes through
                                kernel B1 in f64, plus Bf in f64)
      dx  = solve(A32, r32)  <- a float32 Krylov solve to a loose tolerance,
                                on float32 copies of the operator and of r
      x  += dx               <- float64 update

Each cycle multiplies the residual by the inner solve's reduction factor,
so rtol 1e-8 is reached with every inner matvec in float32. The JAX
package carries x, the residual and the operator as double-float pairs
(`ops/doublefloat.py`) because its TPU has no float64; the H100 has, so
every "_df" argument here (`b_df`, `planes_df`, `Bf_df`) is a float64
tensor, or a tuple of them, and `matvec_df` a float64 matvec. The
solves are host loops that fetch one residual norm per cycle.

The residual's operator is the inner operator's own type over the
float64 arrays: on a distributed operator (parallel/dist.py) the float64
matvec exchanges halos and sums B u over the ranks as the float32 one
does, the "_df" arrays are this rank's patches, and the residual norms
sum over the ranks (`krylov.reduces_over_ranks`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
from saddle_point_petsc_tpu_torch.parallel.dist import DistStencilOperator
from saddle_point_petsc_tpu_torch.solvers import krylov, multigrid, precond
from saddle_point_petsc_tpu_torch.utils.device import resolve_device

_F64, _F32 = torch.float64, torch.float32


@dataclasses.dataclass(frozen=True)
class RefineResult:
    x: Any  # float64 solution: a field, or (u, lam) for the KKT system
    cycles: int
    inner_iterations: int
    rnorm: float  # float64 final residual norm
    rnorm0: float  # norm of the right-hand side
    history: list  # residual norm before each cycle, and the final one
    rtol_target: float = 1e-8

    @property
    def converged(self):
        return bool(self.rnorm <= self.rtol_target * self.rnorm0)


def _refine(residual, correct, x, bnorm, rtol, max_cycles):
    """The refinement loop of every entry point here: up to max_cycles
    corrections, stopping once |r| <= rtol * bnorm.

    residual(x) -> r (float64); correct(r) -> (dx, its) with dx float32.
    Its norms sum over the ranks of the distribution its caller entered
    (`krylov.reduces_over_ranks`). Returns (x, cycles, inner iterations,
    history)."""
    history, inner_total, cycles = [], 0, 0
    for _ in range(max_cycles):
        r = residual(x)
        rn = krylov.tnorm(r).item()
        history.append(rn)
        if rn <= rtol * bnorm:
            break
        dx, its = correct(r)
        inner_total += its
        x = krylov.tadd(x, _to(dx, _F64))
        cycles += 1
    else:
        history.append(krylov.tnorm(residual(x)).item())
    return x, cycles, inner_total, history


def _to(v, dtype):
    """A tensor or a tuple of tensors in `dtype`."""
    return tuple(t.to(dtype) for t in v) if isinstance(v, tuple) else v.to(dtype)


def _shaped_like(name, t, like):
    """t, checked to have the shape of `like` (for a distributed operator,
    this rank's patch): never sliced to fit."""
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the operator's is {tuple(like.shape)} "
                         "(a distributed operator takes this rank's patch)")
    return t


def _with_planes(A, planes):
    """A's own operator type over `planes` (a DistStencilOperator keeps its
    mesh, halo exchange and padding); a StencilOperator when A is a
    stand-in that only carries planes."""
    return dataclasses.replace(A, planes=planes) if dataclasses.is_dataclass(A) else StencilOperator(planes)


@krylov.reduces_over_ranks
def solve_refined(A, b_df, inner_solve: Callable, rtol=1e-8, max_cycles=10, matvec_df: Callable = None):
    """Iterative refinement on a (2, ny, nx)-field operator.

    A: the float32 operator of the inner solve, with `.planes`; its
    `planes_df` (float64 planes), when present, define the residual,
    else its planes widened to float64. The residual's operator is A's own
    type over those planes (`_with_planes`), so a DistStencilOperator's
    residual exchanges its halos. b_df: the float64 right-hand side.
    inner_solve: r32 -> (dx32, iterations), e.g. `inner_cg`. matvec_df:
    an optional float64 matvec replacing the stencil planes' one, with
    which A may be any operator (only the inner solve uses it), such as a
    float64 DistAIJ beside a float32 one (parallel/dist_csr.py: the JAX
    package's `dist_aij_matvec_df`). For a distributed A (one with a mesh)
    the vectors and `planes_df` are this rank's patches and every residual
    norm sums over its ranks.
    """
    if matvec_df is None:
        planes_df = getattr(A, "planes_df", None)
        planes = A.planes if planes_df is None else _shaped_like("planes_df", planes_df, A.planes)
        matvec_df = _with_planes(A, planes.to(_F64))
    bnorm = krylov.tnorm(b_df).item()
    x, cycles, inner_total, history = _refine(
        lambda x: b_df - matvec_df(x), lambda r: inner_solve(_to(r, _F32)),
        torch.zeros_like(b_df), bnorm, rtol, max_cycles,
    )
    return RefineResult(x, cycles, inner_total, history[-1], bnorm, history, rtol)


def make_df_operator(assemble_f64_planes, device=None):
    """The float64 planes of the residual as a float64 tensor on `device`
    (None: the CUDA card), from host-assembled float64 planes. (The JAX
    package splits them into a double-float pair here.)"""
    return torch.tensor(np.asarray(assemble_f64_planes), dtype=_F64, device=resolve_device(device))


def inner_cg(A, M=None, rtol=1e-4, maxiter=200):
    """The standard inner solver for `solve_refined`: CG on A (float32)."""

    def solve(r):
        res = krylov.cg(A, r, M=M, rtol=rtol, maxiter=maxiter)
        return res.x, res.iterations

    return solve


# ---------------------------------------------------------------------------
# KKT (saddle) refinement
# ---------------------------------------------------------------------------


def _kkt_residual(K, b_df, planes_df, Bf_df):
    """residual((u, lam)) = (f - A u - B^T lam, g - B u), all float64,
    through K's own operator type over the float64 planes and rows (kernel
    B1 on a CUDA device): a DistSaddleOperator adds its halo edge terms and
    sums B u over its ranks."""
    planes = K.A.planes if planes_df is None else _shaped_like("planes_df", planes_df, K.A.planes)
    Bf = K.Bf if Bf_df is None else _shaped_like("Bf_df", Bf_df, K.Bf)
    K64 = dataclasses.replace(K, A=_with_planes(K.A, planes.to(_F64)), Bf=Bf.to(_F64))
    f, g = b_df

    def residual(x):
        Au, Bu = K64(x)
        return (f - Au, g - Bu)

    return residual


@krylov.reduces_over_ranks
def solve_refined_kkt(K, b_df, inner_solve, rtol=1e-8, max_cycles=12, planes_df=None, Bf_df=None):
    """Iterative refinement for the KKT system [[A, B^T], [B, 0]].

    K: the float32 SaddleOperator of the inner solve. b_df: the float64
    (f field, g vector). inner_solve: (r_u, r_lam) float32 -> ((du, dlam),
    iterations), e.g. a Schur-preconditioned MINRES. planes_df / Bf_df:
    the float64 planes and constraint rows of the residual (default: K's
    float32 arrays widened to float64), shaped as K's. For a
    DistSaddleOperator f, x's u, planes_df and Bf_df are this rank's
    patches and g and lam are replicated, equal on every rank; the
    residual norm counts them once.
    """
    residual = _kkt_residual(K, b_df, planes_df, Bf_df)
    bnorm = krylov.tnorm(b_df).item()
    x, cycles, inner_total, history = _refine(
        residual, lambda r: inner_solve(*_to(r, _F32)), krylov.tzeros_like(b_df), bnorm, rtol, max_cycles
    )
    return RefineResult(x, cycles, inner_total, history[-1], bnorm, history, rtol)


def solve_refined_kkt_fused(
    K,
    b_df,
    inner_maxiter=1500,
    inner_rtol=1e-4,
    rtol=1e-8,
    max_cycles=12,
    planes_df=None,
    Bf_df=None,
    M=None,
    inner=None,
    inner_operands=None,
):
    """KKT refinement as one callable, with the JAX function's contract.

    Returns a callable that runs the refinement and yields (x, cycles,
    inner_its, rnorm, rnorm0): x the float64 (u, lam), rnorm the final
    float64 residual norm, rnorm0 the right-hand side's. The JAX package
    fuses the loop into one device program; on the GPU it is the host loop
    of `solve_refined_kkt`.

    inner: an optional callable (r_u, r_lam) -> ((du, dlam), its), or
    inner(r_u, r_lam, inner_operands) when `inner_operands` is given,
    replacing the default correction solve: MINRES on K with M (default
    the diag-Schur PC of K) to inner_rtol, at most inner_maxiter
    iterations. A distributed K takes its arguments as
    `solve_refined_kkt` says.
    """
    if M is None:
        M = precond.schur_pc(K.A, K.Bf, fact_type="diag")

    def correct(ru, rlam):
        if inner is None:
            res = krylov.minres(K, (ru, rlam), M=M, rtol=inner_rtol, maxiter=inner_maxiter)
            return res.x, res.iterations
        if inner_operands is not None:
            return inner(ru, rlam, inner_operands)
        return inner(ru, rlam)

    def run():
        res = solve_refined_kkt(K, b_df, correct, rtol, max_cycles, planes_df, Bf_df)
        return res.x, res.cycles, res.inner_iterations, res.rnorm, res.rnorm0

    return run


REFINE_INNERS = ("minres", "minres-diag", "minres-mg", "fgmres-mg")


def kkt_f32(K):
    """The float32 copy of a float64 KKT operator (serial or distributed):
    the operator of the refinement's inner solves, beside the float64 one
    that defines its residual."""
    return dataclasses.replace(K, A=dataclasses.replace(K.A, planes=K.A.planes.float()), Bf=K.Bf.float())


def refine_inner(K32, kind):
    """The float32 correction solve of the JAX bench's refinements on K32,
    built once for every cycle, as keyword arguments (M, inner,
    inner_operands) of `solve_refined_kkt_fused`:

    - `minres` (bench_refined_kkt, bench.py:192-204): MINRES + Schur(diag)
      with a Chebyshev(3) A-block, lmin = lmax / 16, lmax = 1.1 x
      estimate_lmax of Jacobi-preconditioned A;
    - `minres-diag` (bench_refined_kkt_dist): MINRES + Schur(diag, Jacobi);
    - `minres-mg` (config 5): MINRES + Schur(diag) with MG (Chebyshev
      smoother) as its A-block solve;
    - `fgmres-mg` (both): FGMRES (rtol 1e-3, maxiter 60, restart 30) +
      Schur(full, MG), which f32 breaks from about 1025^2 (ROADMAP C).

    The MG is the distributed one on a DistStencilOperator, else the
    serial one."""
    A, Bf = K32.A, K32.Bf
    mg = multigrid.mg_pc_dist if isinstance(A, DistStencilOperator) else multigrid.mg_pc
    if kind == "minres":
        Mj = precond.jacobi(A)
        lmax = 1.1 * precond.estimate_lmax(A, Mj, template=torch.zeros_like(A.diagonal()))
        cheb = precond.chebyshev_pc(A, inner=Mj, lmin=lmax / 16.0, lmax=lmax, iters=3)
        return {"M": precond.schur_pc(A, Bf, cheb, fact_type="diag")}
    if kind == "minres-diag":
        return {"M": precond.schur_pc(A, Bf, fact_type="diag")}
    if kind == "minres-mg":
        return {"M": precond.schur_pc(A, Bf, mg(A, smoother="chebyshev"), "diag")}
    if kind == "fgmres-mg":
        M = precond.schur_pc(A, Bf, inner_solve=mg(A, smoother="chebyshev"), fact_type="full")

        def inner(ru, rlam, ops):
            res = krylov.fgmres(ops[0], (ru, rlam), M=ops[1], rtol=1e-3, maxiter=60, restart=30)
            return res.x, res.iterations

        return {"inner": inner, "inner_operands": (K32, M)}
    raise ValueError(f"inner {kind!r}: one of {REFINE_INNERS}")
