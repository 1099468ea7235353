"""Port parity: the KKT main path of saddle_point_petsc_tpu_torch (saddle
assembly, SaddleOperator, Jacobi and Schur preconditioners, MINRES, CG,
GMRES, FGMRES) against the JAX package, in float64 on the CPU.

Tolerances:
- assembly: 1e-13 * max|ref| (the same formulas, up to an ulp);
- operator and PC applies: rtol = atol = 1e-12 (4-row contractions summed
  in another order);
- Krylov runs: the same iteration count and reason. Residual histories
  entrywise to 1e-10 relative, plus 1000x the reference's own relative
  change, up to that entry, when its right-hand side f is moved by one
  ulp. On this KKT system MINRES's residual estimate passes through
  plateaus where roundoff grows about tenfold per iteration: there the
  JAX package changes by up to ~30% under that one-ulp change (measured
  at 17^2 and 33^2 nodes), and the port's different summation order
  moves it by the same amount. Solutions to 1e-10 relative for CG/GMRES,
  and to 1e-9 for MINRES, whose solution the reference itself moves by
  6e-11 under the one-ulp change at 33^2 nodes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.models import saddle as jsaddle
from saddle_point_petsc_tpu.solvers import krylov as jk
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.solvers.operators import SaddleOperator as JSaddleOperator
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.models import saddle as tsaddle
from saddle_point_petsc_tpu_torch.solvers import krylov as tk
from saddle_point_petsc_tpu_torch.solvers import precond as tpc

torch.set_num_threads(1)

ULP = 1.0 + np.finfo(np.float64).eps


def _np(v):
    if isinstance(v, (tuple, list)):
        return tuple(_np(a) for a in v)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    if not isinstance(ref, tuple):
        got, ref = (got,), (ref,)
    num = sum(np.sum((g - r) ** 2) for g, r in zip(got, ref))
    den = sum(np.sum(r**2) for r in ref)
    return float(np.sqrt(num / den))


def _jax_saddle_arrays(n):
    p = jsaddle.assemble_saddle(n - 1, n - 1, body_force="trig")
    arrays = tuple(np.asarray(a) for a in (p.A.planes, p.Bf, p.f, p.g, p.bc_mask, p.coords))
    return p, arrays


def _assert_same_run(rt, rj, rj_ulp, x_tol):
    assert rt.iterations == int(rj.iterations)
    assert rt.converged_reason == int(rj.converged_reason)
    k = rt.iterations + 1
    hj = np.asarray(rj.history)[:k]
    ht = rt.history.numpy()[:k]
    env = np.maximum.accumulate(np.abs(hj - np.asarray(rj_ulp.history)[:k]) / hj)
    assert np.all(np.abs(ht - hj) <= (1e-10 + 1e3 * env) * hj)
    assert np.all(rt.history.numpy()[k:] == -1.0)
    assert _rel(rt.x, rj.x) <= x_tol


@pytest.mark.parametrize("n", [9, 17])
def test_saddle_from_numpy_matches_port_assembly(n):
    jp, arrays = _jax_saddle_arrays(n)
    got = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu")
    own = tsaddle.assemble_saddle(n - 1, n - 1, body_force="trig", device="cpu")
    for a, b in ((got.A.planes, own.A.planes), (got.Bf, own.Bf), (got.f, own.f),
                 (got.g, own.g), (got.coords, own.coords)):
        assert np.max(np.abs(_np(a) - _np(b))) <= 1e-13 * max(np.max(np.abs(_np(b))), 1e-300)
    assert torch.equal(got.bc_mask, own.bc_mask)
    np.testing.assert_array_equal(_np(got.B), np.asarray(jp.B))


def test_from_numpy_rejects_mismatched_arrays():
    _, (planes, Bf, f, g, mask, coords) = _jax_saddle_arrays(9)
    with pytest.raises(ValueError):
        tsaddle.saddle_problem_from_numpy(planes, Bf[:, :, :-1], f, g, mask, coords, device="cpu")
    with pytest.raises(ValueError):
        tpoisson.poisson_problem_from_numpy(planes, f[:, :-1], mask, coords, device="cpu")


def test_saddle_operator_apply():
    jp, arrays = _jax_saddle_arrays(9)
    tp = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu")
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 9, 9))
    lam = rng.standard_normal(4)
    yt = tp.K((torch.tensor(u), torch.tensor(lam)))
    yj = JSaddleOperator(jp.A, jp.Bf)((jnp.asarray(u), jnp.asarray(lam)))
    for a, b in zip(yt, yj):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fact_type", ["diag", "lower", "upper", "full"])
def test_schur_pc_apply(fact_type):
    jp, arrays = _jax_saddle_arrays(9)
    tp = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu")
    Mj = jpc.schur_pc(jp.A, jp.Bf, fact_type=fact_type)
    Mt = tpc.schur_pc(tp.A, tp.Bf, fact_type=fact_type)
    np.testing.assert_allclose(_np(Mt.S_inv), np.asarray(Mj.S_inv), rtol=1e-12)
    rng = np.random.default_rng(3)
    r = (rng.standard_normal((2, 9, 9)), rng.standard_normal(4))
    zt = Mt(tuple(torch.tensor(a) for a in r))
    zj = Mj(tuple(jnp.asarray(a) for a in r))
    for a, b in zip(zt, zj):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_inv_small(b):
    rng = np.random.default_rng(b)
    M = rng.standard_normal((3, b, b)) + 4.0 * np.eye(b)
    np.testing.assert_allclose(
        _np(tpc.inv_small(torch.tensor(M))), np.asarray(jpc.inv_small(jnp.asarray(M))),
        rtol=1e-12, atol=1e-12,
    )


def test_jacobi_and_identity_pc():
    jp = jpoisson.assemble_poisson(8, 8, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    r = np.random.default_rng(4).standard_normal((2, 9, 9))
    np.testing.assert_allclose(
        _np(tpc.jacobi(tp.A)(torch.tensor(r))), np.asarray(jpc.jacobi(jp.A)(jnp.asarray(r))),
        rtol=1e-12, atol=1e-12,
    )
    x = torch.tensor(r)
    assert tpc.IdentityPC()(x) is x


@pytest.mark.parametrize("n", [17, 33])
def test_minres_saddle_matches(n):
    jp, arrays = _jax_saddle_arrays(n)
    tp = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu")
    Mj = jpc.schur_pc(jp.A, jp.Bf, fact_type="diag")
    rj = jk.minres(jp.K, jp.rhs, M=Mj, rtol=1e-8, maxiter=2000)
    rj_ulp = jk.minres(jp.K, (jp.f * ULP, jp.g), M=Mj, rtol=1e-8, maxiter=2000)
    rt = tk.minres(
        tp.K, tp.rhs, M=tpc.schur_pc(tp.A, tp.Bf, fact_type="diag"), rtol=1e-8, maxiter=2000
    )
    assert rt.reason_name() == "CONVERGED_RTOL"
    _assert_same_run(rt, rj, rj_ulp, x_tol=1e-9)


@pytest.fixture(scope="module")
def poisson17():
    jp = jpoisson.assemble_poisson(16, 16, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    return jp, tp


@pytest.mark.parametrize(
    "solver,kw",
    [
        ("cg", {}),
        ("cg", {"norm_type": "unpreconditioned"}),
        ("gmres", {}),
        ("gmres", {"restart": 10}),
        ("fgmres", {}),
    ],
)
def test_krylov_poisson_matches(poisson17, solver, kw):
    jp, tp = poisson17
    Mj = jpc.jacobi(jp.A)
    rj = jk.SOLVERS[solver](jp.A, jp.f, M=Mj, rtol=1e-8, maxiter=500, **kw)
    rj_ulp = jk.SOLVERS[solver](jp.A, jp.f * ULP, M=Mj, rtol=1e-8, maxiter=500, **kw)
    rt = tk.SOLVERS[solver](tp.A, tp.f, M=tpc.jacobi(tp.A), rtol=1e-8, maxiter=500, **kw)
    assert rt.reason_name() == "CONVERGED_RTOL"
    _assert_same_run(rt, rj, rj_ulp, x_tol=1e-10)


def test_minres_diverged_its_and_zero_rhs():
    """DIVERGED_ITS at maxiter (no hang), and a zero right-hand side
    converges at iteration 0 with x = 0 (PETSc semantics, as the JAX
    package)."""
    _, arrays = _jax_saddle_arrays(9)
    tp = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu")
    M = tpc.schur_pc(tp.A, tp.Bf, fact_type="diag")
    res = tk.minres(tp.K, tp.rhs, M=M, rtol=1e-14, maxiter=5)
    assert res.iterations == 5 and res.reason_name() == "DIVERGED_ITS"
    zero = tk.tzeros_like(tp.rhs)
    res0 = tk.minres(tp.K, zero, M=M, rtol=1e-8, maxiter=5)
    assert res0.iterations == 0 and res0.converged_reason > 0
    assert all(torch.count_nonzero(x) == 0 for x in res0.x)


@pytest.mark.parametrize("constraints", [True, False])
def test_solve_saddle_point_problem_matches(tmp_path, constraints):
    """The high-level driver (assemble, options-configured KSP, VTK) on the
    9x9-node trig problem: MINRES/Schur with constraints, GMRES/Jacobi
    without. u to 1e-8: the 9x9 MINRES run ends in a plateau where a
    one-ulp change of f moves the reference's own u by 1e-9."""
    from saddle_point_petsc_tpu.utils.options import Options

    opts = ["-ksp_rtol", "1e-8"]
    uj, rj, _ = jsaddle.solve_saddle_point_problem(
        8, 8, opts=Options(opts), constraints=constraints, body_force="trig"
    )
    path = tmp_path / "u.vtk"
    ut, rt, _ = tsaddle.solve_saddle_point_problem(
        8, 8, opts=Options(opts), constraints=constraints, body_force="trig", vtk_path=path,
        device="cpu",
    )
    assert (rt.iterations, rt.converged_reason) == (int(rj.iterations), int(rj.converged_reason))
    assert _rel(ut, uj) <= 1e-8
    assert path.exists()
