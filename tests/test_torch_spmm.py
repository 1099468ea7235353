"""Port parity: the SpMM and multi-right-hand-side path (kernels B2, B5 and
B6 through their plain versions, `krylov.cg_multi`, `KSP.mat_solve`)
against the JAX package, on the CPU.

Tolerances: the plain versions against the JAX XLA functions to
1e-12 * max|ref| in f64 (the same products, summed in the same order up to
an ulp); against the Pallas kernels in interpret mode at the tolerances
the JAX package's own tests use (tests/test_spmm.py: 2e-6 for the stencil
SpMM and 2e-5 for the DIA SpMM, both f32; tests/test_pallas.py: 1e-12 for
the ELL SpMV, f64). A batched column against the same product on that
column alone: equal bits (every operation is elementwise over the batch).
`cg_multi` and `mat_solve`: iterations and per-column reasons equal,
histories to 1e-10 relative, x to 1e-10 (cg_multi) and 1e-9 (mat_solve).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.ops import sparse as jsp
from saddle_point_petsc_tpu.ops import stencil as jstencil
from saddle_point_petsc_tpu.ops.pallas import spmm as jspmm
from saddle_point_petsc_tpu.ops.pallas import spmv as jspmv
from saddle_point_petsc_tpu.solvers import krylov as jkrylov
from saddle_point_petsc_tpu.solvers import precond as jprecond
from saddle_point_petsc_tpu.solvers.ksp import KSP as JKSP
from saddle_point_petsc_tpu.utils.options import Options
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.ops import stencil as tstencil
from saddle_point_petsc_tpu_torch.ops.cuda import dia as tdia
from saddle_point_petsc_tpu_torch.ops.cuda import dia_spmm as tdia_spmm
from saddle_point_petsc_tpu_torch.ops.cuda import ell as tell
from saddle_point_petsc_tpu_torch.ops.cuda import spmm as tspmm
from saddle_point_petsc_tpu_torch.solvers import amg as tamg
from saddle_point_petsc_tpu_torch.solvers import krylov as tkrylov
from saddle_point_petsc_tpu_torch.solvers import precond as tprecond
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP as TKSP

torch.set_num_threads(1)

REL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * max(np.max(np.abs(ref), initial=0.0), 1e-300)


# -- B2: the stencil SpMM -----------------------------------------------------


@pytest.mark.parametrize("entry", ["planes_matmat_field", "matmat_field", "matmat"])
def test_stencil_matmat_matches_jax(entry):
    rng = np.random.default_rng(5)
    ny, nx, k = 6, 7, 4
    planes = rng.standard_normal((4, 3, 3, ny, nx))
    opj = jstencil.StencilOperator(jnp.asarray(planes))
    opt = tstencil.StencilOperator(torch.tensor(planes))
    if entry == "matmat":
        X = rng.standard_normal((opt.n, k))
        got, ref = opt.matmat(torch.tensor(X)), opj.matmat(jnp.asarray(X))
        cols = [opt.matvec(torch.tensor(X[:, j])) for j in range(k)]
        got_cols = [got[:, j] for j in range(k)]
    else:
        XT = rng.standard_normal((k, 2, ny, nx))
        if entry == "planes_matmat_field":
            got = tstencil.planes_matmat_field(opt.planes, torch.tensor(XT))
            ref = jstencil.planes_matmat_field(opj.planes, jnp.asarray(XT))
        else:
            got, ref = opt.matmat_field(torch.tensor(XT)), opj.matmat_field(jnp.asarray(XT))
        cols = [opt.matvec_field(torch.tensor(XT[j])) for j in range(k)]
        got_cols = list(got)
    _close(got, ref)
    assert all(torch.equal(g, c) for g, c in zip(got_cols, cols))


def test_stencil_spmm_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    ny, nx, k = 8, 8, 3
    W = rng.standard_normal((ny, nx, 3, 3, 2, 2)).astype(np.float32)
    XT = rng.standard_normal((k, 2, ny, nx)).astype(np.float32)
    planes_j = jstencil.StencilOperator.from_block(jnp.asarray(W)).planes
    want = jspmm.stencil_spmm_pallas(planes_j, jnp.asarray(XT), bm=4, interpret=True)
    got = tspmm.stencil_spmm(torch.tensor(np.asarray(planes_j)), torch.tensor(XT))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-6, atol=2e-6)


# -- B5: the ELL SpMV -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ell_pair():
    """The same ELL in both packages: random rows of different lengths (so
    most rows have padding slots) and an empty row."""
    a = sps.random(61, 61, density=0.08, random_state=np.random.RandomState(4)).tolil()
    a.setdiag(1.0 + np.arange(61))
    a[17, :] = 0.0
    a = a.tocsr()
    a.eliminate_zeros()
    a.sort_indices()
    assert a.indptr[18] == a.indptr[17]
    return jsp.csr_to_ell(jsp.scipy_to_csr(a)), tsp.csr_to_ell(tsp.scipy_to_csr(a, device="cpu"))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_ell_spmv_matches_jax(ref):
    ell_j, ell_t = _ell_pair()
    assert (ell_t.cols < 0).any()
    cols_j, vals_j = jspmv.ell_transpose(ell_j)
    cols_t, vals_t = tsp.ell_transpose(ell_t)
    assert cols_t.dtype == torch.int32 and cols_t.is_contiguous() and vals_t.is_contiguous()
    assert np.array_equal(_np(cols_t), np.asarray(cols_j))
    assert torch.equal(ell_t.cols_t, cols_t) and torch.equal(ell_t.vals_t, vals_t)
    x = np.random.default_rng(6).standard_normal(ell_t.shape[1])
    if ref == "pallas":
        want = jspmv.ell_spmv_pallas(cols_j, vals_j, jnp.asarray(x), interpret=True)
    else:
        want = jsp.ell_matvec(ell_j, jnp.asarray(x))
    xt = torch.tensor(x)
    for got in (tell.ell_spmv_plain(cols_t, vals_t, xt), tell.ell_spmv(cols_t, vals_t, xt),
                tsp.ell_matvec(ell_t, xt), ell_t(xt)):
        _close(got, want)
    assert tell.ell_spmv(cols_t, vals_t, xt)[17].item() == 0.0


# -- B6: the DIA SpMM -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dia_pair():
    """tests/test_spmm.py's random 32 x 32 matrix in both packages."""
    a = sps.random(32, 32, density=0.15, random_state=np.random.RandomState(3))
    a = (a + sps.eye(32)).tocsr()
    a.sort_indices()
    dj, _ = jsp.csr_to_dia(jsp.scipy_to_csr(a))
    return a, dj, tsp.dia_from_numpy(np.asarray(dj.data), dj.offsets, dj.shape, device="cpu")


@pytest.mark.parametrize("layout", ["rows", "transposed"])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_dia_matmat_matches_jax(layout, ref):
    a, dj, dt = _dia_pair()
    k = 4
    X = np.random.default_rng(7).standard_normal((32, k))
    dtype = np.float32 if ref == "pallas" else np.float64
    X = X.astype(dtype)
    Xt = torch.tensor(X) if layout == "rows" else torch.tensor(np.ascontiguousarray(X.T)).T
    assert Xt.is_contiguous() == (layout == "rows")
    At = tsp.DIA(dt.data.to(Xt.dtype), dt.offsets, dt.shape)
    got = tsp.dia_matmat(At, Xt)
    for j in range(k):
        assert torch.equal(got[:, j], tdia.dia_spmv_plain(At.data, Xt[:, j].contiguous(), At.offsets))
    if ref == "pallas":
        want = jspmm.dia_spmm_pallas(dj.data.astype(jnp.float32), jnp.asarray(X), dj.offsets,
                                     bn=16, interpret=True)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(got), a.toarray() @ X, rtol=2e-5, atol=2e-5)
    else:
        _close(got, jsp.dia_matmat(dj, jnp.asarray(X)))
        _close(At.matmat(Xt), dj.matmat(jnp.asarray(X)))


def _offsets_1025():
    """The bands of the 1025^2-node operator in natural order (two fields
    interleaved: rows 2 * 1025 apart), built as csr_to_dia builds them."""
    row = 2 * 1025
    return tuple(r * row + d for r in (-1, 0, 1) for d in range(-3, 4))


_PLAN_CASES = [
    (_offsets_1025(), 2 * 1025 * 1025),
    ((-300, -17, -1, 0, 3, 129, 255), 1000),
    ((-300, -17, -1, 0, 3, 129, 255), 31),
    ((3, -5000, 0, 5000, 1, -64, 64, -2, 2, -3), 31),
    ((3, -5000, 0, 5000, 1, -64, 64, -2, 2, -3), 100003),
    (tuple(range(-10, 11)), 1000),
    (tuple(range(-2000, 2000, 97)), 100003),
    (tuple(int(o) for o in np.random.default_rng(11).integers(-400, 400, 40)), 5000),
    ((-7, 7), 5),
]


@pytest.mark.parametrize("offsets,n", _PLAN_CASES)
def test_dia_spmm_plan_runs(offsets, n):
    """The blocked path's runs hold every band that meets a row once, in the
    order given (so the sum keeps the offsets' order), at most MAX_BANDS a
    run, each run's offsets rising by one; a run ends only where the next
    band cannot join it; the kernel's plan mirrors the runs."""
    runs = tdia_spmm.plan_runs(offsets, n)
    flat = [b for run in runs for b in run]
    assert flat == [(d, o) for d, o in enumerate(offsets) if abs(o) < n]
    for run in runs:
        offs = [o for _, o in run]
        assert 1 <= len(run) <= tdia_spmm.MAX_BANDS
        assert offs == list(range(offs[0], offs[0] + len(offs)))
    for a, b in zip(runs, runs[1:]):
        assert len(a) == tdia_spmm.MAX_BANDS or b[0][1] != a[-1][1] + 1
    plan = tdia_spmm._plan(offsets, n)
    if not 1 <= len(runs) <= tdia_spmm.MAX_RUNS:
        assert plan is None
        return
    assert plan.nruns == len(runs)
    for r, run in enumerate(runs):
        lo, first, cnt = plan.run[r]
        assert (lo, cnt) == (run[0][1], len(run))
        assert [plan.band[first + e] for e in range(cnt)] == [d for d, _ in run]
    if offsets == _offsets_1025():
        assert [len(run) for run in runs] == [7, 7, 7]


def test_dia_spmm_paths_on_cpu():
    """The path choice: blocked for f32 column-contiguous X and Y with a
    plan, the row path for aligned row-major X and Y, strided otherwise."""
    offs, n = _offsets_1025(), 2 * 1025 * 1025
    plan = tdia_spmm._plan(offs, n)
    for dtype in (torch.float32, torch.float64):
        for k, layout, p, want in ((8, "rows", plan, "rows"), (8, "t", plan, "blocked"),
                                   (9, "rows", plan, "strided"), (8, "t", None, "strided"),
                                   (16, "rows", None, "rows")):
            X = torch.zeros((64, k), dtype=dtype)
            X = X if layout == "rows" else X.T.contiguous().T
            if want == "blocked" and dtype == torch.float64:
                want = "strided"
            assert tdia_spmm._path(X, torch.empty_like(X), p) == want, (dtype, k, layout)


# -- cg_multi and KSP.mat_solve -------------------------------------------------


@functools.lru_cache(maxsize=None)
def _poisson(nel):
    """The JAX package's (nel+1)^2-node Poisson stencil problem."""
    return jpoisson.assemble_poisson(nel, nel)


@pytest.mark.parametrize(
    "nel,case",
    [(9, "plain"), (32, "plain"), (9, "zero_column"), (9, "maxiter")],
)
def test_cg_multi_matches_jax(nel, case):
    prob = _poisson(nel)
    f = np.asarray(prob.f)
    cols = [f, 2.0 * f, f * f]
    if case == "zero_column":
        cols[1] = np.zeros_like(f)
    B = np.stack(cols)
    maxiter = 5 if case == "maxiter" else 300
    Mj = jprecond.jacobi(prob.A)
    rj = jkrylov.cg_multi(prob.A.matmat_field, jnp.asarray(B), M=jax.vmap(Mj), rtol=1e-10,
                          maxiter=maxiter)
    At = tstencil.StencilOperator(torch.tensor(np.asarray(prob.A.planes)))
    rt = tkrylov.cg_multi(At.matmat_field, torch.tensor(B), M=tprecond.jacobi(At), rtol=1e-10,
                          maxiter=maxiter)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged_reason.tolist() == np.asarray(rj.converged_reason).tolist()
    want = {"plain": [2, 2, 2], "zero_column": [2, 2, 2], "maxiter": [-3, -3, -3]}[case]
    assert rt.converged_reason.tolist() == want
    assert rt.history.shape == (maxiter + 1, 3)
    _close(rt.history, rj.history, rel=1e-10)
    _close(rt.rnorm, rj.rnorm, rel=1e-10)
    _close(rt.rnorm0, rj.rnorm0, rel=1e-12)
    _close(rt.x, rj.x, rel=1e-10)
    if case == "zero_column":
        assert rt.history[0, 1].item() == 0.0 and not rt.x[1].any()


@functools.lru_cache(maxsize=None)
def _mat_solve_problem():
    """49 x 49 nodes (4,802 rows): the stencil, its CSR and its DIA (21
    offsets) in both packages, and k = 3 right-hand sides b, 2b, b*b as
    (k, 2, ny, nx) fields and as (k, n) natural-order rows."""
    prob = _poisson(48)
    csr = jsp.csr_compact(jsp.coo_to_csr(jstencil.stencil_to_coo(prob.A.W)))
    dia = jsp.csr_to_dia(csr)[0]
    assert len(dia.offsets) == 21
    ops_j = {"stencil": prob.A, "csr": csr, "dia": dia}
    ops_t = {
        "stencil": tstencil.StencilOperator(torch.tensor(np.asarray(prob.A.planes))),
        "csr": tsp.csr_from_numpy(np.asarray(csr.indptr), np.asarray(csr.cols),
                                  np.asarray(csr.vals), csr.shape, device="cpu"),
        "dia": tsp.dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.shape, device="cpu"),
    }
    f = np.asarray(prob.f)
    fl = np.asarray(jstencil.field_to_flat(prob.f))
    return ops_j, ops_t, np.stack([f, 2.0 * f, f * f]), np.stack([fl, 2.0 * fl, fl * fl])


@pytest.mark.parametrize(
    "fmt,pc,its",
    [("stencil", "jacobi", 114), ("stencil", "none", None), ("dia", "jacobi", 114),
     ("dia", "gamg", 8), ("csr", "jacobi", None)],
)
def test_mat_solve_matches_jax(fmt, pc, its):
    ops_j, ops_t, B_field, B_flat = _mat_solve_problem()
    B = B_field if fmt == "stencil" else B_flat
    argv = ["-ksp_type", "cg", "-pc_type", pc, "-ksp_rtol", "1e-8"]
    if pc == "gamg":
        argv += ["-pc_gamg_coarse_eq_limit", "50"]
    kj = JKSP(Options(argv))
    kj.set_operators(ops_j[fmt]).set_from_options().set_up()
    rj = kj.mat_solve(jnp.asarray(B))
    kt = TKSP(Options(argv))
    kt.set_operators(ops_t[fmt]).set_from_options().set_up()
    rt = kt.mat_solve(torch.tensor(B))
    if pc == "gamg":  # four ELL levels run, through B5's plain version
        kinds = [type(lvl.A) for lvl in kt.M.levels]
        assert kinds.count(tamg._EllOp) == 4 and kinds[0] is tsp.DIA
    assert rt.iterations == int(rj.iterations)
    if its is not None:
        assert rt.iterations == its
    assert rt.converged_reason.tolist() == np.asarray(rj.converged_reason).tolist() == [2, 2, 2]
    assert rt.x.shape == B.shape
    _close(rt.x, rj.x, rel=1e-9)


def test_mat_solve_rejects_non_cg():
    ops_j, ops_t, _, B = _mat_solve_problem()
    argv = ["-ksp_type", "gmres", "-pc_type", "none"]
    with pytest.raises(ValueError, match="ksp_type"):
        JKSP(Options(argv)).set_operators(ops_j["dia"]).set_from_options().mat_solve(jnp.asarray(B))
    with pytest.raises(ValueError, match="ksp_type"):
        TKSP(Options(argv)).set_operators(ops_t["dia"]).set_from_options().mat_solve(torch.tensor(B))
