"""Port parity: the preconditioners of saddle_point_petsc_tpu_torch.solvers.
precond that came with geometric multigrid (point-block Jacobi, red-black
SOR, block Jacobi, fieldsplit on the stencil, KSPInnerPC, estimate_lmax)
and their make_pc wiring, against the JAX package, in float64 on the CPU.

Tolerances: every apply to rtol = atol = 1e-12 of the reference (the same
formulas; block Jacobi's dense products sum 2113 terms in another order);
the block inverses bit-equal (both invert the same numpy blocks with
numpy). estimate_lmax draws its start vector in a function of its own,
which the tests replace by the JAX draw (PRNGKey(0)); with the same start
the 10-step power iteration agrees to 1e-12 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.ops import sparse as jsp
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
from saddle_point_petsc_tpu.utils.options import Options as JOptions
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc as tmake_pc
from saddle_point_petsc_tpu_torch.utils.options import Options

torch.set_num_threads(1)


def jax_draw(template, generator):
    """The JAX package's start vector (normal draws from PRNGKey(0), the
    same key for every leaf), as the port's tensors."""

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
def p17():
    return _pair(17)


@pytest.fixture(scope="module")
def csr_pair():
    """The 9 x 8-node Poisson CSR in both packages (144 rows)."""
    return jpoisson.assemble_poisson_csr(8, 7)[0], tpoisson.assemble_poisson_csr(8, 7, device="cpu")[0]


def _close(got, ref):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=1e-12, atol=1e-12 * np.max(np.abs(np.asarray(ref)))
    )


def _field(n, seed):
    return np.random.default_rng(seed).standard_normal((2, n, n))


def test_pbjacobi_apply(p17):
    jp, tp = p17
    Mj, Mt = jpc.pbjacobi(jp.A), tpc.pbjacobi(tp.A)
    _close(Mt.inv_blocks, Mj.inv_blocks)
    r = _field(17, 0)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    flat = r.transpose(1, 2, 0).reshape(-1)  # natural interleaved ordering
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))


def test_pbjacobi_bsr(csr_pair):
    csr_j, csr_t = csr_pair
    Mj = jpc.pbjacobi(jsp.csr_to_bsr(jsp.csr_compact(csr_j), 2))
    Mt = tpc.pbjacobi(tsp.csr_to_bsr(csr_t, 2))
    r = np.random.default_rng(1).standard_normal(csr_t.shape[0])
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    with pytest.raises(TypeError):
        tpc.pbjacobi(csr_t)


@pytest.mark.parametrize("order", ["symmetric", "forward", "backward"])
def test_sor_apply(p17, order):
    jp, tp = p17
    r = _field(17, 2)
    for omega, sweeps in ((1.0, 1), (1.3, 2)):
        Mj = jpc.sor(jp.A, omega=omega, sweeps=sweeps, order=order)
        Mt = tpc.sor(tp.A, omega=omega, sweeps=sweeps, order=order)
        _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    flat = r.transpose(1, 2, 0).reshape(-1)
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))
    with pytest.raises(ValueError):
        tpc.sor(tp.A, order="sideways")


def test_block_jacobi_stencil_apply():
    """Config 1's grid: 65^2 nodes, 8,450 rows, 4 blocks of 2113."""
    jp, tp = _pair(65)
    Mj, Mt = jpc.block_jacobi_stencil(jp.A), tpc.block_jacobi_stencil(tp.A)
    assert tuple(Mt.inv.shape) == (4, 2113, 2113) and Mt.n == 8450
    assert np.array_equal(Mt.inv.numpy(), np.asarray(Mj.inv))
    r = _field(65, 3)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_block_jacobi_csr_and_dense(csr_pair):
    csr_j, csr_t = csr_pair
    r = np.random.default_rng(4).standard_normal(csr_t.shape[0])
    for nb in (5, 7):  # 144 rows: the last block padded with identity
        Mj = jpc.block_jacobi(jsp.csr_compact(csr_j), nb)
        Mt = tpc.block_jacobi(csr_t, nb)
        _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    # 144 rows in 40 blocks of 4: the last four blocks hold padding alone
    # (the JAX function's slicing raises there); they are identity
    Mt = tpc.block_jacobi(csr_t, 40)
    assert Mt.inv.shape == (40, 4, 4) and torch.equal(Mt.inv[36:], torch.eye(4, dtype=torch.float64).expand(4, 4, 4))
    _close(Mt(torch.tensor(r)), jpc.block_jacobi(jsp.csr_compact(csr_j), 36)(jnp.asarray(r)))
    dense = tsp.csr_to_scipy(csr_t).toarray()
    Md = tpc.block_jacobi(dense, 2, max_block=50, device="cpu")  # the cap raises the count to 3
    assert Md.inv.shape[0] == 3
    _close(Md(torch.tensor(r)), jpc.block_jacobi(dense, 2, max_block=50)(jnp.asarray(r)))


@pytest.mark.parametrize("fs_type", ["additive", "multiplicative"])
def test_fieldsplit_apply(p17, fs_type):
    jp, tp = p17
    Mj, Mt = jpc.fieldsplit(jp.A, fs_type=fs_type), tpc.fieldsplit(tp.A, fs_type=fs_type)
    r = _field(17, 5)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    flat = r.transpose(1, 2, 0).reshape(-1)
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))
    x = r[0]
    _close(Mt.A10(torch.tensor(x)), Mj.A10(jnp.asarray(x)))
    with pytest.raises(ValueError):
        tpc.fieldsplit(tp.A, fs_type="schur")


@pytest.mark.parametrize("solver", ["cg", "bcgs", "gmres"])
def test_ksp_inner_pc_apply(p17, solver):
    jp, tp = p17
    Mj = jpc.KSPInnerPC(jp.A, jpc.jacobi(jp.A), solver=solver, rtol=1e-3, maxiter=7)
    Mt = tpc.KSPInnerPC(tp.A, tpc.jacobi(tp.A), solver=solver, rtol=1e-3, maxiter=7)
    r = _field(17, 6)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    with pytest.raises(ValueError):
        tpc.KSPInnerPC(tp.A, None, solver="lsqr")


def test_estimate_lmax_with_the_jax_start(p17, jax_start):
    jp, tp = p17
    tmpl = np.ones((2, 17, 17))
    for Mj, Mt in ((jpc.jacobi(jp.A), tpc.jacobi(tp.A)), (None, None)):
        lj = float(jpc.estimate_lmax(jp.A, Mj, template=jnp.asarray(tmpl)))
        lt = tpc.estimate_lmax(tp.A, Mt, template=torch.tensor(tmpl))
        assert abs(lt - lj) <= 1e-12 * lj
    with pytest.raises(ValueError):
        tpc.estimate_lmax(tp.A)


def test_estimate_lmax_own_start_is_seeded(p17):
    """Without the replacement the port draws from a CPU generator seeded
    with 0: reproducible, and the estimate agrees with the JAX one's to
    the spread a 10-step power iteration leaves from another start
    (measured 0.0058 relative here; 0.0046-0.0089 at 9^2 to 65^2 nodes)."""
    jp, tp = p17
    tmpl = torch.ones((2, 17, 17), dtype=torch.float64)
    M = tpc.jacobi(tp.A)
    a = tpc.estimate_lmax(tp.A, M, template=tmpl)
    assert a == tpc.estimate_lmax(tp.A, M, template=tmpl)
    g = torch.Generator().manual_seed(7)
    assert a != tpc.estimate_lmax(tp.A, M, template=tmpl, generator=g)
    lj = float(jpc.estimate_lmax(jp.A, jpc.jacobi(jp.A), template=jnp.ones((2, 17, 17))))
    assert abs(a - lj) <= 0.02 * lj


_PC_OPTIONS = [
    ("pbjacobi", []),
    ("sor", ["-pc_sor_omega", "1.2", "-pc_sor_its", "2"]),
    ("bjacobi", ["-pc_bjacobi_blocks", "3"]),
    ("chebyshev", ["-pc_chebyshev_its", "4"]),
    ("chebyshev", ["-pc_chebyshev_esteig"]),
    ("fieldsplit", ["-pc_fieldsplit_type", "multiplicative"]),
]


@pytest.mark.parametrize("pc_type,opts", _PC_OPTIONS)
def test_make_pc_matches_jax(p17, jax_start, pc_type, opts):
    jp, tp = p17
    Mj = jmake_pc(pc_type, jp.A, JOptions(opts))
    Mt = tmake_pc(pc_type, tp.A, Options(opts))
    assert type(Mt).__name__ == type(Mj).__name__
    r = _field(17, 7)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_make_pc_refuses(p17, csr_pair):
    _, tp = p17
    csr = csr_pair[1]
    for pc_type in ("sor", "fieldsplit", "mg"):
        with pytest.raises(ValueError):
            tmake_pc(pc_type, csr)
    dia, _ = tsp.csr_to_dia(csr)
    with pytest.raises(ValueError):
        tmake_pc("bjacobi", dia)
    with pytest.raises(ValueError, match="ilu PC requires stencil or CSR operator"):
        tmake_pc("ilu", dia)
