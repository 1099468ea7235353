"""Port parity: the KSP types of saddle_point_petsc_tpu_torch.solvers.krylov
that came with geometric multigrid (richardson, chebyshev, bcgs) against
the JAX package, in float64 on the CPU.

Tolerances (ROADMAP.md, "The reference"): the same iteration count and
converged reason; residual histories entrywise to 1e-10 relative plus
1000x the reference's own relative change, up to that entry, when its
right-hand side is moved by one ulp; solutions to 1e-9 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.solvers import krylov as jk
from saddle_point_petsc_tpu.solvers import multigrid as jmg
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.solvers.ksp import KSP as JKSP
from saddle_point_petsc_tpu.utils.options import Options as JOptions
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.solvers import krylov as tk
from saddle_point_petsc_tpu_torch.solvers import multigrid as tmg
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.utils.options import Options

torch.set_num_threads(1)

ULP = 1.0 + np.finfo(np.float64).eps


def jax_draw(template, generator):
    """The JAX package's estimate_lmax start vector (PRNGKey(0))."""

    def draw(a):
        v = jax.random.normal(jax.random.PRNGKey(0), tuple(a.shape), jnp.float64)
        return torch.tensor(np.asarray(v), dtype=a.dtype)

    return tuple(draw(a) for a in template) if isinstance(template, tuple) else draw(template)


@pytest.fixture(scope="module")
def p17():
    jp = jpoisson.assemble_poisson(16, 16, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    return jp, tp


def _assert_same_run(rt, rj, rj_ulp, x_tol=1e-9):
    assert rt.iterations == int(rj.iterations)
    assert rt.converged_reason == int(rj.converged_reason)
    k = rt.iterations + 1
    hj = np.asarray(rj.history)[:k]
    env = np.maximum.accumulate(np.abs(hj - np.asarray(rj_ulp.history)[:k]) / hj)
    assert np.all(np.abs(rt.history.numpy()[:k] - hj) <= (1e-10 + 1e3 * env) * hj)
    assert np.all(rt.history.numpy()[k:] == -1.0)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= x_tol * np.linalg.norm(xj)


def _pcs(jp, tp, pc):
    if pc == "sor":
        return jpc.sor(jp.A), tpc.sor(tp.A)
    if pc == "mg":
        return jmg.mg_pc(jp.A), tmg.mg_pc(tp.A)
    return jpc.jacobi(jp.A), tpc.jacobi(tp.A)


@pytest.mark.parametrize(
    "solver,pc,kw",
    [
        ("bcgs", "jacobi", {}),
        ("bcgs", "mg", {}),
        ("richardson", "sor", {"maxiter": 20}),
        ("richardson", "mg", {"maxiter": 6}),
        ("richardson", "jacobi", {"maxiter": 30, "scale": 0.7}),
        ("chebyshev", "jacobi", {"lmin": 0.05, "lmax": 2.1}),
        ("chebyshev", "sor", {}),
    ],
)
def test_new_solvers_match_jax(p17, solver, pc, kw):
    jp, tp = p17
    Mj, Mt = _pcs(jp, tp, pc)
    kw = {"maxiter": 500, **kw}
    rj = jk.SOLVERS[solver](jp.A, jp.f, M=Mj, rtol=1e-8, **kw)
    rj_ulp = jk.SOLVERS[solver](jp.A, jp.f * ULP, M=Mj, rtol=1e-8, **kw)
    rt = tk.SOLVERS[solver](tp.A, tp.f, M=Mt, rtol=1e-8, **kw)
    _assert_same_run(rt, rj, rj_ulp)


def test_richardson_runs_every_sweep(p17):
    """No test inside the loop: maxiter sweeps, history[1] == history[0],
    and the reason judges the last residual (DIVERGED_ITS short of rtol)."""
    _, tp = p17
    res = tk.richardson(tp.A, tp.f, M=tpc.jacobi(tp.A), maxiter=7)
    assert res.iterations == 7 and res.reason_name() == "DIVERGED_ITS"
    assert res.history[1] == res.history[0] and (res.history >= 0).all()


def test_bcgs_nonsymmetric_matches_jax():
    """A nonsymmetric operator built in numpy: 1-D convection-diffusion,
    upwinded, 100 unknowns (condition number 731), with a random
    right-hand side."""
    n = 100
    h = 1.0 / (n + 1)
    A = (np.diag(np.full(n, 2.0)) - np.diag(np.ones(n - 1), -1) - np.diag(np.ones(n - 1), 1)) / h**2
    A += 40.0 * (np.diag(np.ones(n)) - np.diag(np.ones(n - 1), -1)) / h  # upwind convection
    assert np.abs(A - A.T).max() > 0
    b = np.random.default_rng(0).standard_normal(n)
    Aj, At = jnp.asarray(A), torch.tensor(A)
    d = np.diag(A)
    rj = jk.bcgs(lambda x: Aj @ x, jnp.asarray(b), M=lambda r: r / jnp.asarray(d), rtol=1e-8, maxiter=400)
    rj_ulp = jk.bcgs(lambda x: Aj @ x, jnp.asarray(b * ULP), M=lambda r: r / jnp.asarray(d), rtol=1e-8,
                     maxiter=400)
    rt = tk.bcgs(lambda x: At @ x, torch.tensor(b), M=lambda r: r / torch.tensor(d), rtol=1e-8, maxiter=400)
    assert rt.reason_name() == "CONVERGED_RTOL"
    _assert_same_run(rt, rj, rj_ulp, x_tol=1e-8)
    assert np.linalg.norm(A @ rt.x.numpy() - b) <= 1e-7 * np.linalg.norm(b)


@pytest.mark.parametrize("solver", ["bcgs", "chebyshev", "richardson"])
def test_zero_rhs_and_diverged_its(p17, solver):
    _, tp = p17
    M = tpc.jacobi(tp.A)
    zero = torch.zeros_like(tp.f)
    res0 = tk.SOLVERS[solver](tp.A, zero, M=M, rtol=1e-8, maxiter=5)
    assert torch.count_nonzero(res0.x) == 0
    if solver != "richardson":
        assert res0.iterations == 0 and res0.converged_reason > 0
    res = tk.SOLVERS[solver](tp.A, tp.f, M=M, rtol=1e-14, maxiter=3)
    assert res.iterations == 3 and res.reason_name() == "DIVERGED_ITS"


@pytest.mark.parametrize(
    "opts",
    [
        ["-ksp_type", "chebyshev", "-pc_type", "jacobi"],  # estimated window
        ["-ksp_type", "chebyshev", "-pc_type", "mg", "-ksp_chebyshev_eigenvalues", "0.1,1.2"],
        ["-ksp_type", "bcgs", "-pc_type", "sor"],
        ["-ksp_type", "richardson", "-pc_type", "mg", "-ksp_max_it", "8"],
    ],
    ids=["chebyshev-esteig", "chebyshev-bounds", "bcgs-sor", "richardson-mg"],
)
def test_ksp_solve_matches_jax(p17, monkeypatch, opts):
    """KSP.solve from options, with the chebyshev KSP's eigenvalue estimate
    started from the JAX draw."""
    monkeypatch.setattr(tpc, "_start_vector", jax_draw)
    jp, tp = p17
    opts = opts + ["-ksp_rtol", "1e-8"]
    rj = JKSP(JOptions(opts)).set_operators(jp.A).set_from_options().solve(jp.f)
    rt = KSP(Options(opts)).set_operators(tp.A).set_from_options().solve(tp.f)
    assert (rt.iterations, rt.converged_reason) == (int(rj.iterations), int(rj.converged_reason))
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-9 * np.linalg.norm(xj)
