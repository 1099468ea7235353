"""Port parity: saddle_point_petsc_tpu_torch.solvers.amg (serial gamg), the
Chebyshev smoother and the CSR Jacobi PC against the JAX package, in
float64 on the CPU.

Tolerances: the hierarchy (aggregates, coarse sizes, omega, level formats
and offsets) exactly, since both packages run the same numpy/scipy setup
on the same matrix; level values, the coarse inverse and one PC apply to
1e-12 * max|ref|; CG + gamg iteration counts equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.ops import sparse as jsp
from saddle_point_petsc_tpu.solvers import amg as jamg
from saddle_point_petsc_tpu.solvers import krylov as jkrylov
from saddle_point_petsc_tpu.solvers import precond as jprecond
from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
from saddle_point_petsc_tpu.utils.options import Options
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
from saddle_point_petsc_tpu_torch.solvers import amg as tamg
from saddle_point_petsc_tpu_torch.solvers import krylov as tkrylov
from saddle_point_petsc_tpu_torch.solvers import precond as tprecond
from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc as tmake_pc

torch.set_num_threads(1)

REL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * max(np.max(np.abs(ref), initial=0.0), 1e-300)


@functools.lru_cache(maxsize=None)
def _jax_problem(n):
    csr, f, _, _ = jpoisson.assemble_poisson_csr(n - 1, n - 1)
    return csr, f


def _problem(n):
    """The JAX package's assembled n x n-node CSR and f, and the port's copies."""
    csr_j, f_j = _jax_problem(n)
    csr_t = tsp.csr_from_numpy(np.asarray(csr_j.indptr), np.asarray(csr_j.cols),
                               np.asarray(csr_j.vals), csr_j.shape, device="cpu")
    return csr_j, f_j, csr_t, torch.tensor(np.asarray(f_j))


def _assert_same_hierarchy(Mt, Mj):
    assert len(Mt.levels) == len(Mj.levels) and Mt.cycles == Mj.cycles
    for lt, lj in zip(Mt.levels, Mj.levels):
        assert np.array_equal(_np(lt.agg), _np(lj.agg))
        assert lt.n_c == lj.n_c and lt.omega == lj.omega
        assert type(lt.A).__name__ == type(lj.A).__name__
        if isinstance(lt.A, tsp.DIA):
            assert lt.A.offsets == lj.A.offsets
            _close(lt.A.data, lj.A.data)
        else:
            assert np.array_equal(_np(lt.A.ell.cols), _np(lj.A.ell.cols))
            _close(lt.A.ell.vals, lj.A.ell.vals)
        _close(lt.s, lj.s)
        _close(lt.dinv, lj.dinv)
        sm_t, sm_j = lt.smoother, lj.smoother
        assert (sm_t.lmin, sm_t.lmax, sm_t.iters) == (sm_j.lmin, sm_j.lmax, sm_j.iters)
    _close(Mt.coarse_inv, Mj.coarse_inv)


@pytest.mark.parametrize("n", [33, 65])
def test_gamg_hierarchy_apply_and_cg_match(n):
    csr_j, f_j, csr_t, f_t = _problem(n)
    Mj, Mt = jamg.amg_pc(csr_j), tamg.amg_pc(csr_t)
    _assert_same_hierarchy(Mt, Mj)
    r = np.random.default_rng(n).standard_normal(csr_t.shape[0])
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    rj = jkrylov.cg(csr_j, f_j, M=Mj, rtol=1e-8, maxiter=100)
    rt = tkrylov.cg(csr_t, f_t, M=Mt, rtol=1e-8, maxiter=100)
    assert rt.iterations == int(rj.iterations) and rt.reason_name() == rj.reason_name()
    _close(rt.x, rj.x, rel=1e-10)


def test_gamg_from_dia_matches_csr_and_jax():
    """_to_scipy undoes csr_to_dia's row-indexed shift exactly, so the
    hierarchy built from the DIA operator is the one built from the CSR."""
    csr_j, _, csr_t, _ = _problem(33)
    dia_j, dia_t = jsp.csr_to_dia(csr_j)[0], tsp.csr_to_dia(csr_t)[0]
    assert abs(tamg._to_scipy(dia_t) - tsp.csr_to_scipy(csr_t)).max() < 1e-15
    Mt = tamg.amg_pc(dia_t)
    _assert_same_hierarchy(Mt, tamg.amg_pc(csr_t))
    _assert_same_hierarchy(Mt, jamg.amg_pc(dia_j))


def test_gamg_on_stencil_field_matches():
    """The saddle route's inner solve: gamg from a stencil operator, applied
    to a (2, ny, nx) field."""
    pj = jpoisson.assemble_poisson(16, 16, body_force="trig")
    St = StencilOperator(torch.tensor(np.asarray(pj.A.planes)))
    Mj, Mt = jamg.amg_pc(pj.A), tamg.amg_pc(St)
    _assert_same_hierarchy(Mt, Mj)
    assert Mt.field_shape == tuple(Mj.field_shape) == (17, 17)
    r = np.random.default_rng(1).standard_normal((2, 17, 17))
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_gamg_w_cycle_and_options_match():
    csr_j, _, csr_t, _ = _problem(33)
    argv = ["-pc_gamg_threshold", "0.05", "-pc_gamg_coarse_eq_limit", "60",
            "-pc_mg_cycles", "2", "-pc_gamg_smooth_its", "3"]
    Mj = jmake_pc("gamg", csr_j, Options(argv))
    Mt = tmake_pc("gamg", csr_t, Options(argv))
    assert Mt.cycles == 2 and len(Mt.levels) >= 2
    _assert_same_hierarchy(Mt, Mj)
    r = np.random.default_rng(2).standard_normal(csr_t.shape[0])
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_gamg_small_system_is_exact_coarse_solve():
    csr_j, _, csr_t, _ = _problem(9)  # 162 rows < coarse_max
    Mj, Mt = jamg.amg_pc(csr_j), tamg.amg_pc(csr_t)
    assert len(Mt.levels) == len(Mj.levels) == 0
    r = np.random.default_rng(3).standard_normal(csr_t.shape[0])
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_gamg_rejects_block_dia_as_jax_does():
    csr_j, _, csr_t, _ = _problem(9)
    with pytest.raises(TypeError):
        jamg.amg_pc(jsp.bsr_to_bdia(jsp.csr_to_bsr(csr_j, 2)))
    with pytest.raises(TypeError):
        tamg.amg_pc(tsp.bsr_to_bdia(tsp.csr_to_bsr(csr_t, 2)))


def test_split_coarse_inverse_is_exact(monkeypatch):
    """Above the dense-solve cap (where the JAX package raises) the
    coarsest level's decoupled boundary rows are split off: the same
    inverse, the same CG iterations."""
    _, _, csr_t, f_t = _problem(65)
    M = tamg.amg_pc(csr_t)
    assert isinstance(M.coarse_inv, torch.Tensor)
    monkeypatch.setattr(tamg, "_COARSE_HARD_CAP", 300)
    Ms = tamg.amg_pc(csr_t)
    ci = Ms.coarse_inv
    assert isinstance(ci, tamg.SplitCoarseInverse)
    assert ci.iso.shape[0] >= 8 * 64  # the eliminated boundary rows, at least
    assert ci.shape == tuple(M.coarse_inv.shape)
    r = torch.tensor(np.random.default_rng(4).standard_normal(ci.shape[0]))
    _close(ci @ r, M.coarse_inv @ r)
    assert tkrylov.cg(csr_t, f_t, M=Ms, rtol=1e-8).iterations == tkrylov.cg(csr_t, f_t, M=M, rtol=1e-8).iterations
    with pytest.raises(ValueError, match="coupled rows"):
        tamg.amg_pc(csr_t, max_levels=2)  # a 1440-row coarsest level


def test_numpy_aggregation_matches_jax_and_native():
    csr_j, _, _, _ = _problem(33)
    S = jamg._strength_graph(jsp.csr_to_scipy(csr_j).astype(np.float64), 0.08)
    agg_t, na_t = tamg._aggregate_numpy(S.indptr, S.indices, S.shape[0])
    agg_j, na_j = jamg._aggregate_numpy(S.indptr, S.indices, S.shape[0])
    assert na_t == na_j and np.array_equal(agg_t, agg_j)
    agg_r, na_r = tamg._aggregate(S)
    assert tamg.aggregation_route in ("native", "numpy")
    assert na_r == na_t and np.array_equal(agg_r, agg_t)


def test_chebyshev_and_jacobi_on_csr_match():
    csr_j, f_j, csr_t, f_t = _problem(17)
    Jj, Jt = jprecond.jacobi(csr_j), tprecond.jacobi(csr_t)
    _close(Jt.inv_diag, Jj.inv_diag)
    rj = jkrylov.chebyshev_fixed(csr_j, f_j, M=Jj, lmin=0.2, lmax=1.9, maxiter=5)
    rt = tkrylov.chebyshev_fixed(csr_t, f_t, M=Jt, lmin=0.2, lmax=1.9, maxiter=5)
    _close(rt.x, rj.x)
    assert abs(rt.rnorm - float(rj.rnorm)) <= 1e-12 * float(rj.rnorm)
    assert rt.iterations == int(rj.iterations) and rt.reason_name() == "CONVERGED_ITS"
    Cj = jprecond.chebyshev_pc(csr_j, lmin=0.3, lmax=1.8, iters=3)
    Ct = tprecond.chebyshev_pc(csr_t, lmin=0.3, lmax=1.8, iters=3)
    _close(Ct(f_t), Cj(f_j))


def test_assembled_problem_gamg_cg_matches():
    """The port's own assembly through gamg: the same CG iterations as the
    JAX package's."""
    csr_t, f_t, _, _ = tpoisson.assemble_poisson_csr(32, 32, device="cpu")
    csr_j, f_j = _jax_problem(33)
    rt = tkrylov.cg(csr_t, f_t, M=tamg.amg_pc(csr_t), rtol=1e-8)
    rj = jkrylov.cg(csr_j, f_j, M=jamg.amg_pc(csr_j), rtol=1e-8)
    assert rt.iterations == int(rj.iterations) == 7
