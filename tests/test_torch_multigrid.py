"""Port parity: saddle_point_petsc_tpu_torch.solvers.multigrid (geometric
multigrid on the stencil) against the JAX package, in float64 on the CPU.

Tolerances:
- prolong and restrict to 1e-14 of max|ref| (the same strided sums in the
  same order), and adjoint to each other to 1e-14;
- the Galerkin coarse planes, level by level, to 1e-13 of max|ref| (169
  products summed in the JAX order), the closed form against comb probing
  to 1e-13;
- the MGPC apply for each smoother to rtol = atol = 1e-12 of the reference
  (the Chebyshev smoother with the JAX start vector for its per-level
  lmax, see test_torch_precond.py);
- Krylov runs with an MG preconditioner: the same iteration count and
  reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.models import saddle as jsaddle
from saddle_point_petsc_tpu.solvers import krylov as jk
from saddle_point_petsc_tpu.solvers import multigrid as jmg
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.utils.options import Options as JOptions
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.models import saddle as tsaddle
from saddle_point_petsc_tpu_torch.solvers import krylov as tk
from saddle_point_petsc_tpu_torch.solvers import multigrid as tmg
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.utils.options import Options

torch.set_num_threads(1)


def jax_draw(template, generator):
    """The JAX package's estimate_lmax start vector (PRNGKey(0))."""

    def draw(a):
        v = jax.random.normal(jax.random.PRNGKey(0), tuple(a.shape), jnp.float64)
        return torch.tensor(np.asarray(v), dtype=a.dtype)

    return tuple(draw(a) for a in template) if isinstance(template, tuple) else draw(template)


@pytest.fixture
def jax_start(monkeypatch):
    monkeypatch.setattr(tpc, "_start_vector", jax_draw)


def _pair(n):
    jp = jpoisson.assemble_poisson(n - 1, n - 1, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    return jp, tp


@pytest.fixture(scope="module")
def pairs():
    return {n: _pair(n) for n in (17, 33)}


def _within(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


def test_prolong_restrict_match_and_are_adjoint():
    rng = np.random.default_rng(0)
    xc, rf = rng.standard_normal((2, 9, 17)), rng.standard_normal((2, 17, 33))
    P = tmg.prolong(torch.tensor(xc), 17, 33)
    R = tmg.restrict(torch.tensor(rf), 9, 17)
    _within(P, jmg.prolong(jnp.asarray(xc), 17, 33), 1e-14)
    _within(R, jmg.restrict(jnp.asarray(rf), 9, 17), 1e-14)
    lhs, rhs = float(torch.sum(P * torch.tensor(rf))), float(torch.sum(torch.tensor(xc) * R))
    assert abs(lhs - rhs) <= 1e-14 * np.sum(np.abs(rf)) * np.max(np.abs(xc))
    batch = rng.standard_normal((3, 2, 5, 5))  # leading axes pass through
    _within(tmg.prolong(torch.tensor(batch), 9, 9), jmg.prolong(jnp.asarray(batch), 9, 9), 1e-14)


@pytest.mark.parametrize("n", [17, 33])
def test_galerkin_levels_match_jax(pairs, n):
    jp, tp = pairs[n]
    Aj, At = jp.A, tp.A
    while At.grid_shape[0] > 5:
        Aj, At = jmg.galerkin_coarse_stencil(Aj), tmg.galerkin_coarse_stencil(At)
        _within(At.planes, Aj.planes, 1e-13)
    probe = tmg.galerkin_coarse_stencil_probe(tp.A)
    _within(probe.planes, tmg.galerkin_coarse_stencil(tp.A).planes, 1e-13)


def test_galerkin_on_random_planes():
    """Random (nonsymmetric, variable) planes on a ragged 17 x 9 grid: the
    closed form against the JAX one and against probing. Entries that
    point outside the grid are zeroed, as in an assembled operator (the
    matvec never reads them, the closed form would)."""
    planes = np.random.default_rng(1).standard_normal((4, 3, 3, 9, 17))
    planes[:, 0, :, 0, :] = planes[:, 2, :, -1, :] = 0.0
    planes[:, :, 0, :, 0] = planes[:, :, 2, :, -1] = 0.0
    from saddle_point_petsc_tpu.ops.stencil import StencilOperator as JS
    from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator as TS

    ct = tmg.galerkin_coarse_stencil(TS(torch.tensor(planes)))
    _within(ct.planes, jmg.galerkin_coarse_stencil(JS(jnp.asarray(planes))).planes, 1e-13)
    _within(tmg.galerkin_coarse_stencil_probe(TS(torch.tensor(planes))).planes, ct.planes, 1e-13)


@pytest.mark.parametrize("smoother", ["sor", "sor-fb", "chebyshev", "jacobi"])
def test_mg_apply_matches_jax(pairs, jax_start, smoother):
    jp, tp = pairs[17]
    Mj, Mt = jmg.mg_pc(jp.A, smoother=smoother), tmg.mg_pc(tp.A, smoother=smoother)
    assert len(Mt.levels) == len(Mj.levels) == 2
    assert np.array_equal(Mt.coarse_inv.numpy(), np.asarray(Mj.coarse_inv))
    r = np.random.default_rng(2).standard_normal((2, 17, 17))
    zj = np.asarray(jax.jit(lambda M, r: M(r))(Mj, jnp.asarray(r)))  # one program, not op by op
    np.testing.assert_allclose(Mt(torch.tensor(r)).numpy(), zj, rtol=1e-12, atol=1e-12 * np.max(np.abs(zj)))


def test_mg_cycles_flat_and_options(pairs):
    jp, tp = pairs[17]
    opts = ["-pc_mg_levels", "2", "-pc_mg_cycles", "2", "-pc_mg_smoother", "sor-fb"]
    Mj, Mt = jmg.mg_pc(jp.A, JOptions(opts)), tmg.mg_pc(tp.A, Options(opts))
    assert len(Mt.levels) == 1 and Mt.cycles == 2 and Mt.coarse_inv.shape == (162, 162)
    r = np.random.default_rng(3).standard_normal(2 * 17 * 17)
    zj = np.asarray(jax.jit(lambda M, r: M(r))(Mj, jnp.asarray(r)))
    np.testing.assert_allclose(Mt(torch.tensor(r)).numpy(), zj, rtol=1e-12, atol=1e-12 * np.max(np.abs(zj)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(3, 3), (5, 7), (9, 9), (36, 36)])
def test_dense_coarsest_matches_jax_loop(shape, dtype):
    """The coarsest level's dense matrix in one scatter against the JAX
    package's loop over nodes, on random block stencils whose off-grid
    entries are set too, a tenth of the entries negative zeros (the loop's
    += stores +0): the same bits."""
    from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator as TS

    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    W = rng.standard_normal((*shape, 3, 3, 2, 2)).astype(dtype)
    W[rng.random(W.shape) < 0.1] = -0.0
    ref = jmg._stencil_to_dense_host(W)
    got = tmg._stencil_to_dense(TS.from_block(torch.tensor(W)).planes).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_singular_coarsest_raises():
    """A 5 x 5 grid too small to coarsen, its stencil the identity but at
    one node, where it is zero: the dense coarse matrix is singular, and
    mg_pc raises numpy's LinAlgError, as the JAX mg_pc does."""
    from saddle_point_petsc_tpu.ops.stencil import StencilOperator as JS
    from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator as TS

    planes = np.zeros((4, 3, 3, 5, 5))
    planes[0, 1, 1] = planes[3, 1, 1] = 1.0
    planes[:, 1, 1, 2, 3] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        jmg.mg_pc(JS(jnp.asarray(planes)))
    with pytest.raises(np.linalg.LinAlgError):
        tmg.mg_pc(TS(torch.tensor(planes)))


def test_even_grid_raises():
    """66 x 66 nodes never coarsen (node counts must be odd), and the
    8,712-dof coarse level passes the 8,192-dof dense cap: both raise."""
    jp, tp = _pair(66)
    with pytest.raises(ValueError, match="too large for a dense coarse solve"):
        jmg.mg_pc(jp.A)
    with pytest.raises(ValueError, match="too large for a dense coarse solve"):
        tmg.mg_pc(tp.A)
    with pytest.raises(ValueError, match="mg smoother"):
        tmg.mg_pc(tp.A, smoother="gauss")


def test_uncoarsenable_small_grid_is_an_exact_solve():
    """4 x 4 nodes cannot coarsen: the hierarchy is the dense inverse
    alone, and the PC solves exactly (the JAX MGPC has no levels[0] to
    read the grid from here and fails)."""
    tp = tpoisson.assemble_poisson(3, 3, body_force="trig", device="cpu")
    M = tmg.mg_pc(tp.A)
    assert not M.levels
    z = M(tp.f)
    assert torch.allclose(tp.A(z), tp.f, rtol=1e-12, atol=1e-12)
    assert torch.allclose(M(tp.f.permute(1, 2, 0).reshape(-1)), z.permute(1, 2, 0).reshape(-1))


@pytest.mark.parametrize("n,smoother", [(17, "sor"), (33, "sor"), (17, "chebyshev")])
def test_cg_mg_iterations_match_jax(pairs, jax_start, n, smoother):
    jp, tp = pairs[n]
    rj = jk.cg(jp.A, jp.f, M=jmg.mg_pc(jp.A, smoother=smoother), rtol=1e-10, maxiter=100)
    rt = tk.cg(tp.A, tp.f, M=tmg.mg_pc(tp.A, smoother=smoother), rtol=1e-10, maxiter=100)
    assert (rt.iterations, rt.converged_reason) == (int(rj.iterations), int(rj.converged_reason))
    assert rt.reason_name() == "CONVERGED_RTOL"
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10 * np.max(np.abs(np.asarray(rj.x))))


def test_fgmres_mg_schur_matches_jax(jax_start):
    """The JAX package's headline inner: FGMRES with a full Schur PC whose
    A-block solve is an MG V-cycle with the Chebyshev smoother, 17^2."""
    jp = jsaddle.assemble_saddle(16, 16, body_force="trig")
    tp = tsaddle.saddle_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.Bf, jp.f, jp.g, jp.bc_mask, jp.coords)), device="cpu"
    )
    Mj = jpc.schur_pc(jp.A, jp.Bf, inner_solve=jmg.mg_pc(jp.A, smoother="chebyshev"), fact_type="full")
    Mt = tpc.schur_pc(tp.A, tp.Bf, inner_solve=tmg.mg_pc(tp.A, smoother="chebyshev"), fact_type="full")
    rj = jk.fgmres(jp.K, jp.rhs, M=Mj, rtol=1e-9, maxiter=100)
    rt = tk.fgmres(tp.K, tp.rhs, M=Mt, rtol=1e-9, maxiter=100)
    assert (rt.iterations, rt.converged_reason) == (int(rj.iterations), int(rj.converged_reason))
    assert rt.reason_name() == "CONVERGED_RTOL" and rt.iterations <= 30


def test_full_schur_with_mg_loses_digits_in_f32(monkeypatch):
    """A limit of the reference algorithm (ROADMAP.md C): FGMRES with a full
    Schur factorization whose A-block solve is an MG V-cycle converges on
    its Arnoldi residual, but in f32 its solution's true residual stalls
    far above rtol, in both packages alike (33^2 nodes: 6e-4 against rtol
    1e-5; it grows about 16x per halving of h). The Schur approximation B
    D^-1 B^T is about h^-2 smaller than the MG block's B A^-1 B^T, so the
    lambda correction and A^-1 B^T of it grow by that factor and cancel in
    the u correction. The upper factorization never subtracts them."""

    def draw32(template, generator):
        v = jax.random.normal(jax.random.PRNGKey(0), tuple(template.shape), jnp.float32)
        return torch.tensor(np.asarray(v))

    monkeypatch.setattr(tpc, "_start_vector", draw32)
    jp = jsaddle.assemble_saddle(32, 32, body_force="trig")
    arrays = [np.asarray(a) for a in (jp.A.planes, jp.Bf, jp.f, jp.g, jp.bc_mask, jp.coords)]
    t64 = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu")
    t32 = tsaddle.saddle_problem_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    from saddle_point_petsc_tpu.ops.stencil import StencilOperator as JS
    from saddle_point_petsc_tpu.solvers.operators import SaddleOperator as JK

    Aj = JS(jp.A.planes.astype(jnp.float32))
    Kj, Bfj = JK(Aj, jp.Bf.astype(jnp.float32)), jp.Bf.astype(jnp.float32)
    rhs_j = (jp.f.astype(jnp.float32), jp.g.astype(jnp.float32))

    def true_rel(x):
        x64 = tuple(torch.tensor(np.asarray(a), dtype=torch.float64) for a in x)
        r = tk.tsub(t64.rhs, t64.K(x64))
        return float(tk.tnorm(r) / tk.tnorm(t64.rhs))

    Mj = jpc.schur_pc(Aj, Bfj, inner_solve=jmg.mg_pc(Aj, smoother="chebyshev"), fact_type="full")
    rj = jk.fgmres(Kj, rhs_j, M=Mj, rtol=1e-5, maxiter=100)
    assert int(rj.converged_reason) > 0 and true_rel(rj.x) >= 10 * 1e-5  # the reference stalls
    mg = tmg.mg_pc(t32.A, smoother="chebyshev")
    for fact in ("full", "upper"):
        rt = tk.fgmres(t32.K, t32.rhs, M=tpc.schur_pc(t32.A, t32.Bf, inner_solve=mg, fact_type=fact),
                       rtol=1e-5, maxiter=100)
        assert rt.reason_name() == "CONVERGED_RTOL"
        if fact == "full":
            assert true_rel(rt.x) >= 10 * 1e-5  # the port stalls alike
        else:
            assert true_rel(rt.x) <= 2 * 1e-5
