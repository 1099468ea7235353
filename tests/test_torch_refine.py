"""Port parity: saddle_point_petsc_tpu_torch.solvers.refine (mixed-precision
iterative refinement, float64 residuals around float32 inner solves)
against the JAX package's double-float refinement, on the CPU.

The JAX package's residual is a double-float pair (about 1e-14 accurate),
the port's is float64 (about 1e-16); the float32 inner iterates of the two
packages differ at the 1e-7 level (their sums run in other orders). So the
tests hold the number of refinement cycles equal, require both packages to
reach rtol, and hold x to a bound derived from the residual: for K x* = b
and a final residual r = b - K x, ||x - x*|| <= ||K^-1|| ||r|| <=
cond(K) * (||r|| / ||b||) * ||x*||, with cond(K) computed from the dense
matrix of the 17^2-node problem and ||r|| / ||b|| <= rtol, each package's
x against the dense matrix's exact solution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.models import saddle as jsaddle
from saddle_point_petsc_tpu.ops.doublefloat import df_from_f64, df_to_f64
from saddle_point_petsc_tpu.ops.stencil import StencilOperator as JStencil
from saddle_point_petsc_tpu.solvers import krylov as jk
from saddle_point_petsc_tpu.solvers import multigrid as jmg
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.solvers import refine as jrefine
from saddle_point_petsc_tpu.solvers.operators import SaddleOperator as JSaddle
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator, field_to_flat
from saddle_point_petsc_tpu_torch.solvers import amg
from saddle_point_petsc_tpu_torch.solvers import krylov as tk
from saddle_point_petsc_tpu_torch.solvers import multigrid as tmg
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.solvers import refine as trefine
from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


def jax_draw(template, generator):
    """The JAX package's estimate_lmax start vector (PRNGKey(0), drawn in
    the template's dtype)."""

    def draw(a):
        jdt = jnp.float32 if a.dtype == F32 else jnp.float64
        v = jax.random.normal(jax.random.PRNGKey(0), tuple(a.shape), jdt)
        return torch.tensor(np.asarray(v), dtype=a.dtype)

    return tuple(draw(a) for a in template) if isinstance(template, tuple) else draw(template)


@pytest.fixture(scope="module")
def kkt17():
    """The 17^2-node trig KKT system: the JAX problem, its arrays, the dense
    matrix and its exact solution (natural ordering), and cond(K)."""
    jp = jsaddle.assemble_saddle(16, 16, body_force="trig")
    planes, Bf, f, g = (np.asarray(a) for a in (jp.A.planes, jp.Bf, jp.f, jp.g))
    A = amg._to_scipy(StencilOperator(torch.tensor(planes))).toarray()
    B = Bf.transpose(0, 2, 3, 1).reshape(Bf.shape[0], -1)
    K = np.block([[A, B.T], [B, np.zeros((B.shape[0], B.shape[0]))]])
    rhs = np.concatenate([f.transpose(1, 2, 0).reshape(-1), g])
    return jp, (planes, Bf, f, g), np.linalg.solve(K, rhs), np.linalg.cond(K)


def _kkt32(planes, Bf):
    A32 = StencilOperator(torch.tensor(planes, dtype=F32))
    return SaddleOperator(A32, torch.tensor(Bf, dtype=F32))


def _jkkt32(planes, Bf):
    return JSaddle(JStencil(jnp.asarray(planes.astype(np.float32))), jnp.asarray(Bf.astype(np.float32)))


def _kkt_x_err(u, lam, x_star):
    x = np.concatenate([np.asarray(u).transpose(1, 2, 0).reshape(-1), np.asarray(lam)])
    return np.linalg.norm(x - x_star) / np.linalg.norm(x_star)


def test_solve_refined_poisson_matches_jax():
    """f32 inner CG (rtol 1e-4) around f64 residuals to rtol 1e-10."""
    jp = jpoisson.assemble_poisson(16, 16, body_force="trig")
    planes64, b64 = np.asarray(jp.A.planes), np.asarray(jp.f)

    class DFOp:  # the JAX test's operator: f32 planes and their df pair
        planes = jnp.asarray(planes64.astype(np.float32))
        planes_df = df_from_f64(planes64)

    rj = jrefine.solve_refined(DFOp(), df_from_f64(b64), jrefine.inner_cg(JStencil(DFOp.planes), rtol=1e-4,
                                                                          maxiter=300), rtol=1e-10, max_cycles=8)

    class Op:
        planes = torch.tensor(planes64, dtype=F32)
        planes_df = trefine.make_df_operator(planes64, device="cpu")

    rt = trefine.solve_refined(Op(), torch.tensor(b64), trefine.inner_cg(StencilOperator(Op.planes), rtol=1e-4,
                                                                          maxiter=300), rtol=1e-10, max_cycles=8)
    assert rt.x.dtype == F64 and rt.cycles == rj.cycles >= 2
    assert rt.converged and rj.converged and rt.rnorm <= 1e-10 * rt.rnorm0
    assert len(rt.history) == len(rj.history) == rt.cycles + 1
    A = amg._to_scipy(StencilOperator(torch.tensor(planes64))).toarray()
    x_star = np.linalg.solve(A, b64.transpose(1, 2, 0).reshape(-1))
    bound = np.linalg.cond(A) * 1e-10
    for x in (field_to_flat(rt.x).numpy(), field_to_flat(torch.tensor(np.asarray(df_to_f64(rj.x)))).numpy()):
        assert np.linalg.norm(x - x_star) <= bound * np.linalg.norm(x_star)


def test_solve_refined_kkt_matches_jax(kkt17):
    """Diag-Schur MINRES in f32 (rtol 1e-4) as the correction solve, to
    rtol 1e-9."""
    _, (planes, Bf, f, g), x_star, cond = kkt17
    Kj = _jkkt32(planes, Bf)
    Mj = jpc.schur_pc(Kj.A, Kj.Bf, fact_type="diag")

    def inner_j(ru, rlam):
        res = jk.minres(Kj, (ru, rlam), M=Mj, rtol=1e-4, maxiter=600)
        return res.x, int(res.iterations)

    rj = jrefine.solve_refined_kkt(Kj, (df_from_f64(f), df_from_f64(g)), inner_j, rtol=1e-9,
                                   planes_df=df_from_f64(planes), Bf_df=df_from_f64(Bf))
    Kt = _kkt32(planes, Bf)
    Mt = tpc.schur_pc(Kt.A, Kt.Bf, fact_type="diag")

    def inner_t(ru, rlam):
        res = tk.minres(Kt, (ru, rlam), M=Mt, rtol=1e-4, maxiter=600)
        return res.x, res.iterations

    rt = trefine.solve_refined_kkt(Kt, (torch.tensor(f), torch.tensor(g)), inner_t, rtol=1e-9,
                                   planes_df=torch.tensor(planes), Bf_df=torch.tensor(Bf))
    assert rt.cycles == rj.cycles >= 2
    assert rt.rnorm <= 1e-9 * rt.rnorm0 and rj.rnorm <= 1e-9 * rj.rnorm0
    assert _kkt_x_err(*rt.x, x_star) <= cond * 1e-9
    assert _kkt_x_err(df_to_f64(rj.x[0]), df_to_f64(rj.x[1]), x_star) <= cond * 1e-9


@pytest.mark.parametrize("inner_kind", ["minres", "fgmres-mg"])
def test_fused_matches_jax(kkt17, monkeypatch, inner_kind):
    """solve_refined_kkt_fused to rtol 1e-8, with its default diag-Schur
    MINRES correction (inner rtol 1e-4) or with the JAX bench's FGMRES +
    MG-Schur inner (bench.py `bench_refined_kkt`: FGMRES to rtol 1e-3,
    maxiter 60, restart 30; a full Schur PC whose A-block solve is an MG
    V-cycle with the Chebyshev smoother) passed through inner_operands."""
    monkeypatch.setattr(tpc, "_start_vector", jax_draw)
    _, (planes, Bf, f, g), x_star, cond = kkt17
    Kj, Kt = _jkkt32(planes, Bf), _kkt32(planes, Bf)
    kw_j = dict(planes_df=df_from_f64(planes), Bf_df=df_from_f64(Bf), rtol=1e-8, inner_rtol=1e-4)
    kw_t = dict(planes_df=torch.tensor(planes), Bf_df=torch.tensor(Bf), rtol=1e-8, inner_rtol=1e-4)
    if inner_kind == "fgmres-mg":
        Mj = jpc.schur_pc(Kj.A, Kj.Bf, inner_solve=jmg.mg_pc(Kj.A, smoother="chebyshev"), fact_type="full")
        Mt = tpc.schur_pc(Kt.A, Kt.Bf, inner_solve=tmg.mg_pc(Kt.A, smoother="chebyshev"), fact_type="full")

        def inner_j(ru, rlam, ops):
            res = jk.fgmres(ops[0], (ru, rlam), M=ops[1], rtol=1e-3, maxiter=60, restart=30)
            return res.x, res.iterations

        def inner_t(ru, rlam, ops):
            res = tk.fgmres(ops[0], (ru, rlam), M=ops[1], rtol=1e-3, maxiter=60, restart=30)
            return res.x, res.iterations

        kw_j.update(inner=inner_j, inner_operands=(Kj, Mj))
        kw_t.update(inner=inner_t, inner_operands=(Kt, Mt))
    xj, cyc_j, its_j, rn_j, bn_j = jax.device_get(
        jrefine.solve_refined_kkt_fused(Kj, (df_from_f64(f), df_from_f64(g)), **kw_j)())
    xt, cyc_t, its_t, rn_t, bn_t = trefine.solve_refined_kkt_fused(Kt, (torch.tensor(f), torch.tensor(g)), **kw_t)()
    assert cyc_t == int(cyc_j) >= 2
    assert rn_t <= 1e-8 * bn_t and float(rn_j) <= 1e-8 * float(bn_j)
    assert xt[0].dtype == xt[1].dtype == F64
    err_t = _kkt_x_err(*xt, x_star)
    assert err_t <= cond * 1e-8
    uj, lamj = (df_to_f64(type(xj[i])(np.asarray(xj[i].hi), np.asarray(xj[i].lo))) for i in (0, 1))
    assert _kkt_x_err(uj, lamj, x_star) <= cond * 1e-8
    if inner_kind == "fgmres-mg":
        assert its_t <= 30 * cyc_t  # MG keeps each correction short


def test_make_df_operator_is_f64():
    planes = np.random.default_rng(0).standard_normal((4, 3, 3, 5, 6))
    t = trefine.make_df_operator(planes, device="cpu")
    assert t.dtype == F64 and np.array_equal(t.numpy(), planes)
