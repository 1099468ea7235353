"""Port parity: ILU(0) of saddle_point_petsc_tpu_torch (precond.ilu0 on a
CSR, ilu_stencil.stencil_ilu0 on a stencil operator, the native
factorization and its Python fallback, make_pc wiring) against the JAX
package, in float64 on the CPU on 17^2 nodes (578 rows), inputs from
numpy given to both packages.

Tolerances:
- factors bit-equal: the port's native ILU(0) and the JAX package's (the
  JAX build contracts the update into one fused multiply-add on this
  host; the port's code writes it as std::fma), and the two Python
  fallbacks; the native and the Python factors, which round the update
  twice, differ by ulps (1e-14 relative);
- _slot_table (generated without a sort) equal to the JAX one, and the
  stencil-form factors bit-equal;
- applies to 1e-12 of max|z| of the JAX ones; the exact path (the CSR's
  level-scheduled solves) also against dense triangular solves of the
  same factors;
- the port's stencil-form and CSR applies bit-equal on the CPU when the
  CSR holds the same planes (as the JAX package asserts of its own);
- Krylov iteration counts and reasons equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.models import saddle as jsaddle
from saddle_point_petsc_tpu.ops import sparse as jsp
from saddle_point_petsc_tpu.ops.stencil import stencil_to_coo as jstencil_to_coo
from saddle_point_petsc_tpu.solvers import ilu_stencil as jis
from saddle_point_petsc_tpu.solvers import krylov as jk
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
from saddle_point_petsc_tpu.utils import native as jnative
from saddle_point_petsc_tpu.utils.options import Options as JOptions
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.models import saddle as tsaddle
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.ops.stencil import field_to_flat
from saddle_point_petsc_tpu_torch.solvers import ilu_stencil as tis
from saddle_point_petsc_tpu_torch.solvers import krylov as tk
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc as tmake_pc
from saddle_point_petsc_tpu_torch.utils import native as tnative
from saddle_point_petsc_tpu_torch.utils.options import Options

torch.set_num_threads(1)

N = 17


@pytest.fixture(scope="module")
def p17():
    jp = jpoisson.assemble_poisson(N - 1, N - 1, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    return jp, tp


@pytest.fixture(scope="module")
def csr17(p17):
    """The 17^2-node operator as a CSR in both packages, from the same planes."""
    jp, _ = p17
    cj = jsp.csr_compact(jsp.coo_to_csr(jstencil_to_coo(jp.A.W)))
    ct = tsp.csr_from_numpy(*(np.asarray(a) for a in (cj.indptr, cj.cols, cj.vals)), cj.shape, device="cpu")
    return cj, ct


def _random_csr():
    """A random diagonally dominant 300 x 300 CSR, sorted indices."""
    rng = np.random.default_rng(1)
    a = sps.random(300, 300, density=0.03, random_state=2, format="csr")
    a = (a + sps.diags(rng.uniform(5.0, 6.0, 300))).tocsr()
    a.sort_indices()
    return a


def _scipy(kind, csr17):
    return jsp.csr_to_scipy(csr17[0]) if kind == "assembled" else _random_csr()


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-12 * np.max(np.abs(ref)))


def _field(seed):
    return np.random.default_rng(seed).standard_normal((2, N, N))


def _needs_native():
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler for the native host libraries")


@pytest.mark.parametrize("kind", ["assembled", "random"])
def test_factors_match_jax(csr17, kind):
    _needs_native()
    a = _scipy(kind, csr17)
    n = a.shape[0]
    d_jax = jnative.ilu0(a.indptr, a.indices, a.data.copy(), n)
    d_port = tnative.ilu0(a.indptr.astype(np.int64), a.indices.astype(np.int64), a.data, n)
    assert np.array_equal(d_port, d_jax)
    p_jax = jpc._ilu0_python(a.indptr, a.indices, a.data.copy(), n)
    p_port = tpc._ilu0_python(a.indptr, a.indices, a.data.copy(), n)
    assert np.array_equal(p_port, p_jax)
    np.testing.assert_allclose(p_port, d_port, rtol=1e-14, atol=1e-14 * np.max(np.abs(d_port)))
    # ilu0_factor_host: L and U bit-equal, patterns equal
    Lj, Uj = jpc.ilu0_factor_host(jsp.scipy_to_csr(a))
    Lt, Ut = tpc.ilu0_factor_host(tsp.scipy_to_csr(a, device="cpu"))
    for got, ref in ((Lt, Lj), (Ut, Uj)):
        for field in ("indptr", "cols", "vals"):
            assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))


def test_zero_pivot_and_missing_diagonal():
    _needs_native()
    missing = sps.csr_matrix(np.array([[2.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 2.0]]))
    missing.eliminate_zeros()  # row 1 has no stored diagonal
    # a00 stored as an explicit 0: the pivot of row 1
    pivot = sps.csr_matrix((np.array([0.0, 1.0, 1.0, 1.0]), np.array([0, 1, 0, 1]), np.array([0, 2, 4])),
                           shape=(2, 2))
    for a in (missing, pivot):
        n = a.shape[0]
        for lib in (jnative, tnative):
            with pytest.raises(ZeroDivisionError, match="zero pivot at row"):
                lib.ilu0(a.indptr, a.indices, a.data.copy(), n)
    # a CSR whose arrays disagree with n is refused before the library call
    with pytest.raises(ValueError, match="row pointers"):
        tnative.ilu0(pivot.indptr, pivot.indices, pivot.data, 3)
    # missing diagonal: both factorizations raise ValueError (JAX: from
    # its Python fallback after the native call raised)
    for fac, to_csr in ((jpc.ilu0_factor_host, jsp.scipy_to_csr),
                        (tpc.ilu0_factor_host, lambda a: tsp.scipy_to_csr(a, device="cpu"))):
        with pytest.raises(ValueError, match="missing diagonal in row 1"):
            fac(to_csr(missing))
    with pytest.raises(ValueError, match="missing diagonal in row 1"):
        tpc._ilu0_python(missing.indptr, missing.indices, missing.data.copy(), 3)
    # zero pivot: the JAX factorization falls back to its Python loop and
    # returns non-finite factors; the port raises
    with np.errstate(divide="ignore", invalid="ignore"):
        Lj, _ = jpc.ilu0_factor_host(jsp.scipy_to_csr(pivot))
    assert not np.all(np.isfinite(np.asarray(Lj.vals)))
    with pytest.raises(ZeroDivisionError, match="zero pivot at row 0"):
        tpc.ilu0_factor_host(tsp.scipy_to_csr(pivot, device="cpu"))
    with pytest.raises(ZeroDivisionError, match="zero pivot at row 0"):
        tpc._ilu0_python(pivot.indptr, pivot.indices, pivot.data.copy(), 2)


@pytest.mark.parametrize("sweeps", [1, 6])
def test_ilu0pc_sweeps_match_jax(csr17, sweeps):
    cj, ct = csr17
    Mj, Mt = jpc.ilu0(cj, sweeps=sweeps), tpc.ilu0(ct, sweeps=sweeps)
    assert Mt.lower is None and Mt.upper is None  # no schedules for the sweep path
    r = _field(0)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))  # dof-major field
    flat = r.transpose(1, 2, 0).reshape(-1)
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))
    _close(Mt(torch.tensor(flat.reshape(-1, 2))), Mj(jnp.asarray(flat.reshape(-1, 2))))


def test_exact_path_matches_jax_scan_and_dense(csr17):
    cj, ct = csr17
    Mj, Mt = jpc.ilu0(cj, sweeps=0), tpc.ilu0(ct, sweeps=0)
    flat = _field(1).transpose(1, 2, 0).reshape(-1)
    z = Mt(torch.tensor(flat))
    _close(z, Mj(jnp.asarray(flat)))
    # dense triangular solves of the same factors
    n = ct.shape[0]
    Ld = tsp.csr_to_scipy(Mt.L).toarray() + np.eye(n)
    Ud = tsp.csr_to_scipy(Mt.U).toarray() + np.diag(1.0 / Mt.inv_udiag.numpy())
    _close(z, np.linalg.solve(Ud, np.linalg.solve(Ld, flat)))
    # each level depends on earlier levels only; far fewer levels than rows
    for sched, tri in ((Mt.lower, Ld - np.eye(n)), (Mt.upper, np.triu(Ud, 1))):
        level = np.empty(n, np.int64)
        for lev, (a, b) in enumerate(zip(sched.bounds[:-1], sched.bounds[1:])):
            level[sched.rows[a:b].numpy()] = lev
        deps = np.nonzero(tri)
        assert np.all(level[deps[1]] < level[deps[0]])
        assert sched.levels < n // 4


def test_stencil_ilu0_host_matches_jax(p17):
    _needs_native()
    jp, tp = p17
    for got, ref in zip(tis.stencil_ilu0_host(tp.A.planes.numpy()), jis.stencil_ilu0_host(np.asarray(jp.A.planes))):
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (3, 5), (6, 4), (17, 17)])
def test_slot_table_matches_jax(shape):
    for got, ref in zip(tis._slot_table(*shape), jis._slot_table(*shape)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("sweeps", [1, 6])
def test_stencil_ilu0_apply(p17, csr17, sweeps):
    """Against the JAX StencilILU0PC to 1e-12, and bit-equal to the port's
    CSR ILU0PC at the same sweeps (the CSR holds the same planes)."""
    jp, tp = p17
    Mt = tis.stencil_ilu0(tp.A, sweeps=sweeps)
    assert isinstance(Mt, tis.StencilILU0PC) and Mt.Lp.dtype == torch.float64
    r = _field(2)
    z = Mt(torch.tensor(r))
    _close(z, jis.stencil_ilu0(jp.A, sweeps=sweeps)(jnp.asarray(r)))
    z_csr = tpc.ilu0(csr17[1], sweeps=sweeps)(field_to_flat(torch.tensor(r)))
    assert torch.equal(field_to_flat(z), z_csr)
    assert torch.equal(Mt(field_to_flat(torch.tensor(r))), z_csr)  # flat input


def test_stencil_ilu0_no_sweeps_matches_jax(p17):
    """sweeps == 0 on a stencil: D^-1 alone, as the JAX StencilILU0PC
    applies it (the exact solves are the CSR ILU0PC's)."""
    jp, tp = p17
    Mt = tis.stencil_ilu0(tp.A, sweeps=0)
    assert isinstance(Mt, tis.StencilILU0PC) and Mt.sweeps == 0
    r = _field(3)
    z = Mt(torch.tensor(r))
    assert torch.equal(z, Mt.invd * torch.tensor(r))
    _close(z, jis.stencil_ilu0(jp.A, sweeps=0)(jnp.asarray(r)))


def test_make_pc_ilu(p17, csr17):
    jp, tp = p17
    cj, ct = csr17
    for Aj, At, opts in ((jp.A, tp.A, []), (cj, ct, []), (cj, ct, ["-pc_ilu_sweeps", "0"]),
                         (jp.A, tp.A, ["-pc_ilu_sweeps", "0"]), (jp.A, tp.A, ["-pc_ilu_sweeps", "3"])):
        Mj, Mt = jmake_pc("ilu", Aj, JOptions(opts)), tmake_pc("ilu", At, Options(opts))
        assert type(Mt).__name__ == type(Mj).__name__ and Mt.sweeps == Mj.sweeps
    assert isinstance(tmake_pc("ilu", ct, Options(["-pc_ilu_sweeps", "0"])).lower, tpc.LevelSchedule)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
@pytest.mark.parametrize("fmt", ["stencil", "csr"])
def test_krylov_with_ilu_matches_jax(p17, csr17, solver, fmt):
    jp, tp = p17
    if fmt == "stencil":
        (Aj, bj), (At, bt) = (jp.A, jp.f), (tp.A, tp.f)
    else:
        (Aj, At), f = csr17, np.asarray(jp.f).transpose(1, 2, 0).reshape(-1)
        bj, bt = jnp.asarray(f), torch.tensor(f)
    Mj, Mt = jmake_pc("ilu", Aj, JOptions()), tmake_pc("ilu", At, Options())
    rj = getattr(jk, solver)(Aj, bj, M=Mj, rtol=1e-10, maxiter=200)
    rt = getattr(tk, solver)(At, bt, M=Mt, rtol=1e-10, maxiter=200)
    assert (rt.iterations, rt.converged_reason) == (int(rj.iterations), int(rj.converged_reason))
    assert rt.reason_name() == "CONVERGED_RTOL"
    _close(rt.x, rj.x)


def test_fgmres_schur_inner_ilu_matches_jax():
    """-fieldsplit_inner_pc_type ilu on the saddle system: FGMRES with an
    upper Schur factorization whose A-block solve is the stencil ILU(0)."""
    jp = jsaddle.assemble_saddle(N - 1, N - 1, body_force="trig")
    tp = tsaddle.saddle_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.Bf, jp.f, jp.g, jp.bc_mask, jp.coords)), device="cpu"
    )
    opts = ["-pc_fieldsplit_schur_fact_type", "upper", "-fieldsplit_inner_pc_type", "ilu"]
    Mj = jmake_pc("fieldsplit", jp.K, JOptions(opts), ksp_type="fgmres")
    Mt = tmake_pc("fieldsplit", tp.K, Options(opts), ksp_type="fgmres")
    assert isinstance(Mt.inner_solve, tis.StencilILU0PC)
    rj = jk.fgmres(jp.K, jp.rhs, M=Mj, rtol=1e-9, maxiter=200)
    rt = tk.fgmres(tp.K, tp.rhs, M=Mt, rtol=1e-9, maxiter=200)
    assert (rt.iterations, rt.converged_reason) == (int(rj.iterations), int(rj.converged_reason))
    assert rt.reason_name() == "CONVERGED_RTOL"
