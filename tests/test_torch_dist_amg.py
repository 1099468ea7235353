"""Port parity: the distributed gamg of saddle_point_petsc_tpu_torch
(solvers/amg.py's dist_amg_pc with the global and the streaming setup,
parallel/dist_csr.py's dist_aij_from_rows and fetch_rows, make_pc's gamg
on a DistAIJ, the CLI's -mat_type aij -dist -pc_type gamg) and the twin of
the JAX package's entry hooks (graft_entry.py) against the JAX package on
`dist_csr.make_mesh_1d(4)` of fake CPU devices, in float64.

One module-scoped gloo world of 4 ranks runs every distributed case of the
port once: this file, run as a script, is the worker (the launcher is
tests/test_torch_dist.py's `_launch`); each rank imports no jax, and rank
0 returns every rank's results, gathered. The parent builds the JAX
references in process from the same numpy inputs (made by
np.random.default_rng with a fixed seed). The CLI runs as 4 `python -m
saddle_point_petsc_tpu_torch.cli -dist -mat_type aij -pc_type gamg`
processes against the JAX library on make_mesh_1d(4).

Tolerances:
- dist_aij_from_rows's plan and statics (built on the mesh's device)
  equal dist_aij_from_scipy's (the host plan) exactly, field by field,
  values in f64 and f32, or both raise the same ValueError on every rank;
  fetch_rows returns the owners' rows exactly;
- the global setup: each rank's rows of every level's A, P and R equal the
  JAX shards to 1e-13 of their largest entry (the same host numpy on the
  same inputs); the smoother bounds to 1e-13;
- the streaming setup: each rank's aggregates equal the JAX package's
  shards', rho (the smoothers' bounds) to 1e-12, P and Ac to 1e-12 (the
  port sums the Galerkin contributions in another order);
- CG counts within 1 of the JAX package's (the ranks' partial dots reduce
  in another order than the JAX psum), x to 1e-6 relative + 1e-9; the
  stream count also at most the global count + 6 (tests/test_amg.py's
  allowance for aggregates that stop at rank boundaries), its true
  residual below 1e-7;
- the coarse solve above the 4096-row cap (SplitCoarseInverse, where the
  JAX package raises) against scipy's spsolve to 1e-12;
- the twin: the MINRES rnorm of the JAX steps (f32) to 1e-4 relative, the
  CG count within 1; entry()'s operands to 1e-5, its x to 1e-5 of max|x|
  plus twice the JAX step's own change under a one-ulp change of f (its
  25 f32 MINRES iterations end in a plateau).
"""
import pickle
import re
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from test_torch_dist import _launch

from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh

WORLD = 4
PLAN_FIELDS = ("diag_cols_t", "diag_vals_t", "off_cols_t", "off_vals_t", "send_idx", "dia_data", "ghost_cols",
               "dia_offsets", "shape", "n_pad", "n_pad_col", "has_ghosts")
# dist_aij_from_rows against dist_aij_from_scipy: case -> (matrix, dia, dtype)
FROM_ROWS = {
    "rand5": ("rand5", "auto", None),
    "q1": ("q1", "auto", None),
    "q1_ell": ("q1", "off", None),
    "rect": ("rect", "auto", None),  # P-shaped: more rows than columns
    "nooff": ("nooff", "auto", None),
    "rand5_f32": ("rand5", "auto", "float32"),
    "q1_force_f32": ("q1", "force", "float32"),
    "rect_t_f32": ("rect_t", "auto", "float32"),  # R-shaped: fewer rows than columns
    "short": ("short", "auto", None),  # 9 rows: the last rank holds padding rows alone
    "short_rect_f32": ("short_rect", "auto", "float32"),  # 9 rows: the last rank holds none
    "irregular": ("irregular", "auto", None),  # the band test fails: ELL
    "irregular_force": ("irregular", "force", None),  # ... and raises on every rank
}
SETUPS = ("global", "stream")
CLI_OPTS = ["-mat_type", "aij", "-da_grid_x", "33", "-da_grid_y", "25", "-ksp_type", "cg", "-pc_type", "gamg",
            "-ksp_rtol", "1e-8", "-ksp_converged_reason"]


def poisson2d(n):
    """tests/test_amg.py's 5-point matrix (4 on each 1-D diagonal)."""
    ix = sps.identity(n)
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n))
    return (sps.kron(ix, t) + sps.kron(t, ix)).tocsr()


def _my_rows(a, rank):
    """Rank `rank`'s block of rows of scipy a, zero rows past its end: the
    (n_loc, n) block dist_aij_from_rows takes."""
    m = a.shape[0]
    n_loc = -(-m // WORLD)
    blk = a.tocsr()[rank * n_loc : min((rank + 1) * n_loc, m)]
    return sps.vstack([blk, sps.csr_matrix((n_loc - blk.shape[0], a.shape[1]))]).tocsr()


# ---------------------------------------------------------------------------
# the worker: one rank of the 4-rank gloo world (no jax)
# ---------------------------------------------------------------------------


def _worker(inp_path, out_path):
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch import graft_entry
    from saddle_point_petsc_tpu_torch.parallel import dist_csr as dc
    from saddle_point_petsc_tpu_torch.solvers import amg, krylov
    from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc
    from saddle_point_petsc_tpu_torch.utils.options import Options

    torch.set_num_threads(1)
    with open(inp_path, "rb") as fh:
        inp = pickle.load(fh)
    dev, _ = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    m = dc.make_mesh_1d(device=dev)
    me = {}

    def plan(A):
        out = {}
        for k in PLAN_FIELDS:
            v = getattr(A, k)
            out[k] = v.numpy() if isinstance(v, torch.Tensor) else v
        return out

    def rows(t):  # the global vector, gathered
        return pmesh.gather_rows(t, m).numpy()

    def plan_or_error(build):
        try:
            return plan(build())
        except ValueError as e:
            return str(e)

    # (a) dist_aij_from_rows against dist_aij_from_scipy
    for name, (key, dia, dtype) in FROM_ROWS.items():
        a = inp[key]
        me[f"plan_{name}"] = (
            plan_or_error(lambda: dc.dist_aij_from_scipy(a, m, dtype=dtype, dia=dia)),
            plan_or_error(lambda: dc.dist_aij_from_rows(_my_rows(a, m.rank), a.shape[1], m, dtype=dtype, dia=dia,
                                                        n_rows=a.shape[0])))
    # (b) fetch_rows
    for name in ("rand5", "rect"):
        me[f"fetch_{name}"] = dc.fetch_rows(_my_rows(inp[name], m.rank), inp[f"want_{name}"][m.rank], m)

    # (c), (d) the hierarchies and their CG on poisson2d(40)
    a = inp["a40"]
    A = dc.dist_aij_from_scipy(a, m)
    b = dc.pad_vector(inp["b40"], A.n_pad, m)
    for setup in SETUPS:
        M = amg.dist_amg_pc(A, a_scipy=a if setup == "global" else None, coarse_max=100, setup=setup)
        me[f"{setup}_levels"] = [
            {"n": lvl.A.shape[0], "lmax": lvl.smoother.lmax, "A": lvl.A.to_scipy_rows(), "P": lvl.P.to_scipy_rows(),
             "R": lvl.R.to_scipy_rows(), "n_pad_c": lvl.n_pad_c} for lvl in M.levels]
        res = krylov.cg(A, b, M=M, rtol=1e-8, maxiter=100)
        me[f"{setup}_cg"] = (res.iterations, res.reason_name(), rows(res.x))
    me["stream_agg"] = amg._dist_amg_stream_level(A, 0.08, 2)[3]

    # (e) the streaming setup with every global-matrix route patched to raise
    def refuse(*args, **kwargs):
        raise AssertionError("a global matrix on the streaming path")

    gathered = []
    real_gather = dc.gather_scipy_rows

    def gather(part, mesh):
        out = real_gather(part, mesh)
        gathered.append(out.shape)
        return out

    patches = [(dc.DistAIJ, "to_scipy", refuse), (dc, "dist_aij_from_scipy", refuse),
               (dc, "dist_aij_from_coo", refuse), (dc, "gather_rows", refuse), (pmesh, "gather_rows", refuse),
               (dc, "gather_scipy_rows", gather)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        M = amg.dist_amg_pc(A, coarse_max=100, setup="stream")
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    me["no_global"] = ([lvl.A.shape[0] for lvl in M.levels], gathered, M.coarse_inv.shape)

    # (f) make_pc and Options, the empty hierarchy, the W-cycle, the split coarse solve
    a32 = inp["a32"]
    A32 = dc.dist_aij_from_scipy(a32, m)
    b32 = dc.pad_vector(inp["b32"], A32.n_pad, m)
    for setup in SETUPS:
        M = make_pc("gamg", A32, Options(["-pc_gamg_setup", setup, "-pc_gamg_coarse_eq_limit", "150"]))
        res = krylov.cg(A32, b32, M=M, rtol=1e-8, maxiter=60)
        me[f"make_pc_{setup}"] = (type(M).__name__, len(M.levels), res.iterations, res.reason_name())
    me["make_pc_default"] = len(make_pc("gamg", A32, Options(["-pc_gamg_coarse_eq_limit", "150"])).levels) == len(
        amg.dist_amg_pc(A32, coarse_max=150).levels)
    a10 = inp["a10"]
    A10 = dc.dist_aij_from_scipy(a10, m)
    for setup in SETUPS:
        M = amg.dist_amg_pc(A10, a_scipy=a10 if setup == "global" else None, setup=setup)
        res = krylov.cg(A10, dc.pad_vector(inp["b10"], A10.n_pad, m), M=M, rtol=1e-8, maxiter=10)
        me[f"empty_{setup}"] = (len(M.levels), res.iterations, res.reason_name())
    a48 = inp["a48"]
    A48 = dc.dist_aij_from_scipy(a48, m)
    b48 = dc.pad_vector(inp["b48"], A48.n_pad, m)
    r1, r2 = (dc.pad_vector(inp[k], A48.n_pad, m) for k in ("r1", "r2"))
    for cycles in (1, 2):
        M = amg.dist_amg_pc(A48, a_scipy=a48, coarse_max=60, cycles=cycles)
        res = krylov.cg(A48, b48, M=M, rtol=1e-8, maxiter=300)
        me[f"cycles{cycles}"] = (len(M.levels), res.iterations, res.reason_name())
        if cycles == 2:
            with krylov.distributed(m, A48.dist_leaves):
                me["w_symmetry"] = [krylov.tdot(M(r1), r2).item(), krylov.tdot(r1, M(r2)).item()]
    asplit = inp["split"]
    As = dc.dist_aij_from_scipy(asplit, m)
    M = amg.dist_amg_pc(As, a_scipy=asplit, coarse_max=10**6)
    me["split"] = (type(M.coarse_inv).__name__, len(M.levels), rows(M(dc.pad_vector(inp["b_split"], As.n_pad, m))))
    try:
        amg.dist_amg_pc(As, coarse_max=10**6, setup="stream")
        me["split_stream"] = None
    except ValueError as e:
        me["split_stream"] = str(e)

    # (h) the twin of the JAX package's multichip hook
    me["dryrun"] = graft_entry.dryrun_multichip(device="cpu")

    me["jax_loaded"] = sorted(k for k in sys.modules if k == "jax" or k.startswith("saddle_point_petsc_tpu."))
    everyone = [None] * m.size
    dist.all_gather_object(everyone, me)
    if m.rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(everyone, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    from saddle_point_petsc_tpu.models import poisson as jpoisson
    from saddle_point_petsc_tpu.ops import sparse as jsp

    rng = np.random.default_rng(10)
    p = poisson2d(9)[:63, :63].tocoo()  # a 5-point pattern, 63 rows: padded to 64
    rand5 = sps.csr_matrix((rng.standard_normal(p.nnz) + 4.0 * (p.row == p.col), (p.row, p.col)), shape=p.shape)
    q1 = jsp.csr_to_scipy(jpoisson.assemble_poisson_csr(16, 12)[0]).tocsr()  # 442 rows
    rect = sps.random(50, 23, density=0.2, random_state=np.random.RandomState(3), format="csr")
    # no entry outside the diagonal blocks of the 4 ranks' rows (13, 13, 13, 11)
    nooff = sps.block_diag([sps.random(k, k, density=0.3, random_state=np.random.RandomState(k)) + sps.identity(k)
                            for k in (13, 13, 13, 11)]).tocsr()
    # more than 4096 rows, all but 225 decoupled, shuffled over the ranks
    split = sps.block_diag([sps.diags(rng.uniform(1.0, 2.0, 4300)), poisson2d(15)]).tocsr()
    perm = rng.permutation(split.shape[0])
    split = split[perm][:, perm].tocsr()
    return {
        "rand5": rand5, "q1": q1, "rect": rect, "nooff": nooff, "rect_t": rect.T.tocsr(), "short": poisson2d(3),
        "short_rect": sps.random(9, 30, density=0.4, random_state=np.random.RandomState(5), format="csr"),
        "irregular": (sps.random(64, 64, density=0.3, random_state=np.random.RandomState(6))
                      + sps.identity(64)).tocsr(),
        "want_rand5": [rng.choice(63, size=k, replace=False) for k in (5, 0, 63, 17)],
        "want_rect": [rng.choice(50, size=k, replace=False) for k in (9, 50, 1, 0)],
        "a40": poisson2d(40), "b40": rng.standard_normal(1600),
        "a32": poisson2d(32), "b32": rng.standard_normal(1024),
        "a10": poisson2d(10), "b10": rng.standard_normal(100),
        "a48": poisson2d(48), "b48": rng.standard_normal(2304), "r1": rng.standard_normal(2304),
        "r2": rng.standard_normal(2304),
        "split": split, "b_split": rng.standard_normal(split.shape[0]),
    }


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_amg")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    outs = _launch([str(Path(__file__)), str(tmp / "in.pkl"), str(tmp / "out.pkl")], WORLD, tmp)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    with open(tmp / "out.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def jref(inputs):
    """The JAX package's distributed gamg on make_mesh_1d(4)."""
    from saddle_point_petsc_tpu.parallel import dist_csr as jdc
    from saddle_point_petsc_tpu.solvers import amg as jamg
    from saddle_point_petsc_tpu.solvers import krylov as jk

    mesh = jdc.make_mesh_1d(WORLD)
    out = {"mesh": mesh}
    a = inputs["a40"]
    A = jdc.dist_aij_from_scipy(a, mesh)
    b = jdc.pad_vector(inputs["b40"], A.n_pad, mesh)
    for setup in SETUPS:
        M = jamg.dist_amg_pc(A, a_scipy=a if setup == "global" else None, coarse_max=100, setup=setup)
        out[f"{setup}_levels"] = [
            {"n": lvl.A.shape[0], "lmax": lvl.smoother.lmax, "n_pad_c": lvl.n_pad_c,
             **{k: [getattr(lvl, k).to_scipy_rows(s) for s in range(WORLD)] for k in ("A", "P", "R")}}
            for lvl in M.levels]
        res = jk.cg(A, b, M=M, rtol=1e-8, maxiter=100)
        out[f"{setup}_cg"] = (int(res.iterations), res.reason_name(), np.asarray(res.x))
    # the streaming setup's first-level aggregates, shard by shard (amg.py:584-606)
    n_loc, aggs, off = A.n_loc, [], 0
    for s in range(WORLD):
        m_s = max(min((s + 1) * n_loc, a.shape[0]) - s * n_loc, 0)
        blk = A.to_scipy_rows(s)[:m_s, s * n_loc : s * n_loc + m_s].tocsr()
        agg, na = jamg._aggregate(jamg._strength_graph(blk, 0.08))
        aggs.append(agg.astype(np.int64) + off)
        off += na
    out["stream_agg"] = aggs
    A48 = jdc.dist_aij_from_scipy(inputs["a48"], mesh)
    b48 = jdc.pad_vector(inputs["b48"], A48.n_pad, mesh)
    M = jamg.dist_amg_pc(A48, a_scipy=inputs["a48"], coarse_max=60, cycles=2)
    out["cycles2"] = int(jk.cg(A48, b48, M=M, rtol=1e-8, maxiter=300).iterations)
    return out


def _rel_equal(got, want, tol, what):
    assert got.shape == want.shape, what
    scale = max(abs(want).max(), 1e-300)
    assert abs(got - want).max() <= tol * scale, (what, abs(got - want).max() / scale)


@pytest.mark.parametrize("name", FROM_ROWS)
def test_from_rows_plan_equals_from_scipy(world, name):
    """Every rank's plan and statics built from its own rows on the mesh's
    device equal those dist_aij_from_scipy builds on the host from the
    global matrix, field by field and bit for bit; where the band test
    fails under dia="force", both raise the same ValueError on every
    rank."""
    mat, dia, dtype = FROM_ROWS[name]
    if name == "irregular_force":
        for w in world:
            ref, got = w[f"plan_{name}"]
            assert isinstance(ref, str) and got == ref and "diag bands" in ref
        return
    for rank, w in enumerate(world):
        ref, got = w[f"plan_{name}"]
        assert ref["diag_vals_t"].dtype == np.dtype(dtype or "float64"), rank
        for key, want in ref.items():
            if isinstance(want, np.ndarray):
                assert got[key].shape == want.shape and got[key].dtype == want.dtype, (rank, key)
                np.testing.assert_array_equal(got[key], want, err_msg=f"rank {rank} {key}")
            else:
                assert got[key] == want, (rank, key, got[key], want)
    ref = world[0][f"plan_{name}"][0]
    assert ref["has_ghosts"] == (mat != "nooff")
    if mat in ("q1", "irregular"):
        assert (ref["dia_data"] is not None) == (mat == "q1" and dia != "off")
    if mat.startswith("short"):  # 3 rows a rank: the last rank's, 9-11, are all padding
        assert ref["n_pad"] == 12


@pytest.mark.parametrize("name", ["rand5", "rect"])
def test_fetch_rows_returns_the_owners_rows(world, inputs, name):
    for rank, w in enumerate(world):
        want = inputs[name].tocsr()[inputs[f"want_{name}"][rank]]
        got = w[f"fetch_{name}"]
        assert got.shape == want.shape and (got != want).nnz == 0, rank


def test_global_setup_equals_the_jax_shards(world, jref):
    """The global setup is the serial pipeline on every rank: the levels'
    sizes, each rank's rows of A, P and R and the smoother bounds equal
    the JAX package's."""
    ref = jref["global_levels"]
    assert len(ref) >= 1
    for rank, w in enumerate(world):
        got = w["global_levels"]
        assert [lv["n"] for lv in got] == [lv["n"] for lv in ref]
        for k, (g, r) in enumerate(zip(got, ref)):
            assert g["n_pad_c"] == r["n_pad_c"]
            np.testing.assert_allclose(g["lmax"], r["lmax"], rtol=1e-13)
            for key in ("A", "P", "R"):
                _rel_equal(g[key].toarray(), r[key][rank].toarray(), 1e-13, (rank, k, key))


def test_stream_setup_matches_jax(world, jref):
    """The streaming setup from each rank's own rows: the same aggregates,
    rho, P and Ac as the JAX package's streaming setup."""
    for rank, w in enumerate(world):
        np.testing.assert_array_equal(w["stream_agg"], jref["stream_agg"][rank])
    ref = jref["stream_levels"]
    assert len(ref) >= 1
    for rank, w in enumerate(world):
        got = w["stream_levels"]
        assert [lv["n"] for lv in got] == [lv["n"] for lv in ref]
        for k, (g, r) in enumerate(zip(got, ref)):
            assert g["n_pad_c"] == r["n_pad_c"]
            np.testing.assert_allclose(g["lmax"], r["lmax"], rtol=1e-12)
            for key in ("A", "P", "R"):
                _rel_equal(g[key].toarray(), r[key][rank].toarray(), 1e-12, (rank, k, key))


@pytest.mark.parametrize("setup", SETUPS)
def test_cg_matches_jax(world, jref, inputs, setup):
    its, reason, x = world[0][f"{setup}_cg"]
    its_j, reason_j, x_j = jref[f"{setup}_cg"]
    assert reason == reason_j == "CONVERGED_RTOL"
    assert abs(its - its_j) <= 1, (its, its_j)
    np.testing.assert_allclose(x, x_j, rtol=1e-6, atol=1e-9)
    assert all(w[f"{setup}_cg"][:2] == (its, reason) for w in world)
    if setup == "stream":
        assert its <= world[0]["global_cg"][0] + 6
        a, b = inputs["a40"], inputs["b40"]
        assert np.linalg.norm(a @ x[: a.shape[0]] - b) < 1e-7 * np.linalg.norm(b)


def test_stream_setup_holds_no_global_matrix(world):
    """With DistAIJ.to_scipy, dist_aij_from_scipy, dist_aij_from_coo and
    gather_rows refusing, the streaming setup still builds its levels;
    the one matrix it gathers is the coarsest level's, once, for the
    replicated coarse solve."""
    for w in world:
        sizes, gathered, coarse = w["no_global"]
        assert len(sizes) >= 2
        assert sizes == [lv["n"] for lv in w["stream_levels"]]
        assert len(gathered) == 1 and gathered[0][0] == coarse[0] < sizes[-1]


@pytest.mark.parametrize("setup", SETUPS)
def test_make_pc_gamg_on_a_dist_aij(world, setup):
    """-pc_type gamg on a DistAIJ builds the distributed hierarchy, with
    -pc_gamg_setup read from the options (global by default), and CG
    converges in AMG-class counts (tests/test_amg.py:148-165, :331-345)."""
    for w in world:
        name, levels, its, reason = w[f"make_pc_{setup}"]
        assert name == "DistAMGPC" and levels >= 1 and reason == "CONVERGED_RTOL" and its <= 25
        assert w["make_pc_default"]


@pytest.mark.parametrize("setup", SETUPS)
def test_empty_hierarchy_is_the_exact_solve(world, setup):
    for w in world:
        levels, its, reason = w[f"empty_{setup}"]
        assert levels == 0 and reason == "CONVERGED_RTOL" and its <= 2


def test_w_cycle_is_symmetric_and_matches_jax(world, jref):
    lhs, rhs = world[0]["w_symmetry"]
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)
    levels, its_w, reason = world[0]["cycles2"]
    assert levels >= 2 and reason == "CONVERGED_RTOL"
    assert its_w <= world[0]["cycles1"][1]
    assert abs(its_w - jref["cycles2"]) <= 1, (its_w, jref["cycles2"])


def test_split_coarse_solve_above_the_cap(world, inputs):
    """An empty hierarchy on 4525 rows, all but 225 decoupled: the coarse
    solve splits the decoupled rows off (the JAX package raises at its
    4096-row cap) and is exact; the streaming setup, which would have to
    gather the whole matrix, raises the JAX package's ValueError."""
    import scipy.sparse.linalg as spla

    a, b = inputs["split"], inputs["b_split"]
    want = spla.spsolve(a.tocsc(), b)
    for w in world:
        name, levels, z = w["split"]
        assert name == "SplitCoarseInverse" and levels == 0
        np.testing.assert_allclose(z[: a.shape[0]], want, rtol=0, atol=1e-12 * abs(want).max())
        assert "aggregation produced no coarsening at 4525 rows" in w["split_stream"]


def test_dryrun_multichip_matches_jax(world):
    """graft_entry.dryrun_multichip() on the 4-rank world against the JAX
    hook's steps: MINRES + Schur(diag) + per-patch ILU(0) on the f32 SPMD
    assembly of the (2, 2) fake-device mesh, and CG under the JAX
    dist_amg_pc(setup="stream") on make_mesh_1d(4)."""
    import jax
    import jax.numpy as jnp

    from saddle_point_petsc_tpu.parallel import dist as jd
    from saddle_point_petsc_tpu.parallel import dist_csr as jdc
    from saddle_point_petsc_tpu.parallel.mesh import make_mesh
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu.solvers import precond as jpc
    from saddle_point_petsc_tpu.solvers.amg import dist_amg_pc as jdist_amg_pc
    from saddle_point_petsc_tpu.solvers.ilu_stencil import dist_ilu0 as jdist_ilu0

    mesh = make_mesh(WORLD, shape=(2, 2))
    grid = jd.DistGrid.create(7, 7, mesh)
    K, rhs, _ = jax.jit(lambda: jd.assemble_saddle_dist(grid, dtype=jnp.float32, body_force="trig"))()
    M = jpc.schur_pc(K.A, K.Bf, jdist_ilu0(K.A, sweeps=4), fact_type="diag")
    minres = jk.minres(K, rhs, M=M, rtol=1e-3, maxiter=5)
    n1 = max(4 * WORLD, 16)
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n1, n1))
    a = (sps.kron(sps.identity(n1), t) + sps.kron(t, sps.identity(n1))).tocsr().astype(np.float32)
    mesh1 = jdc.make_mesh_1d(WORLD)
    Ad = jdc.dist_aij_from_scipy(a, mesh1)
    cg = jk.cg(Ad, jdc.pad_vector(np.ones(a.shape[0], np.float32), Ad.n_pad, mesh1),
               M=jdist_amg_pc(Ad, setup="stream", coarse_max=64), rtol=1e-4, maxiter=20)
    for w in world:
        got = w["dryrun"]
        np.testing.assert_allclose(got["minres_rnorm"], float(minres.rnorm), rtol=1e-4)
        assert abs(got["cg_its"] - int(cg.iterations)) <= 1, (got["cg_its"], int(cg.iterations))
        assert np.isfinite(got["cg_rnorm"]) and len(got["cg_levels"]) >= 1


def test_entry_matches_jax():
    """graft_entry.entry() on the CPU against the JAX entry(): the f32
    operands to 1e-5 of their largest entry (the same formulas rounded
    apart: up to ~10 ulps of f32); the step's x (u and lam) to 1e-5 of max|x| plus twice the JAX
    step's own change when f moves by one ulp either way: twenty-five f32
    MINRES iterations end in a plateau where that change is as large as
    the two packages' difference, so no fixed tolerance below it holds."""
    import jax

    import __graft_entry__ as jentry
    from saddle_point_petsc_tpu_torch import graft_entry

    fn, (K, (f, g)) = jentry.entry()
    jstep = jax.jit(fn)
    (ju, jlam), _ = jstep(K, (f, g))
    ref = (np.asarray(ju), np.asarray(jlam))
    moved = []
    for s in (1 + 2.0**-23, 1 - 2.0**-23):
        xm, _ = jstep(K, (f * s, g))
        moved.append([np.asarray(x) / s for x in xm])
    step, (Kt, (ft, gt)) = graft_entry.entry(device="cpu")
    for got, want in ((Kt.A.planes, K.A.planes), (Kt.Bf, K.Bf), (ft, f), (gt, g)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    (u, lam), rnorm = step(Kt, (ft, gt))
    assert np.isfinite(rnorm)
    for k, got in enumerate((u.numpy(), lam.numpy())):
        sens = max(np.abs(m[k] - ref[k]).max() for m in moved)
        assert np.abs(got - ref[k]).max() <= 1e-5 * np.abs(ref[k]).max() + 2 * sens, (k, sens)


def test_port_never_imports_jax(world):
    assert all(w["jax_loaded"] == [] for w in world)


ITS = re.compile(r"its=(\d+), reason=(\w+)")


@pytest.mark.parametrize("setup", SETUPS)
def test_cli_four_ranks_matches_jax(tmp_path, jref, setup):
    """`python -m saddle_point_petsc_tpu_torch.cli -dist -mat_type aij
    -pc_type gamg [-pc_gamg_setup stream]` in a spawned 4-rank gloo world:
    rank 0's its= line within 1 of the JAX library's on make_mesh_1d(4)."""
    from saddle_point_petsc_tpu.models import poisson as jpoisson
    from saddle_point_petsc_tpu.ops import sparse as jsp
    from saddle_point_petsc_tpu.parallel import dist_csr as jdc
    from saddle_point_petsc_tpu.solvers.ksp import KSP as JKSP
    from saddle_point_petsc_tpu.utils.options import Options as JOptions

    opts = CLI_OPTS + ["-pc_gamg_setup", setup]
    outs = _launch(["-m", "saddle_point_petsc_tpu_torch.cli", "-device", "cpu", "-dist", "-no_vtk"] + opts, WORLD,
                   tmp_path)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    csr, f, _, _ = jpoisson.assemble_poisson_csr(32, 24)
    mesh = jref["mesh"]
    A = jdc.dist_aij_from_scipy(jsp.csr_to_scipy(csr), mesh, dtype="float64")
    res = JKSP(JOptions(opts)).set_operators(A).set_from_options().solve(jdc.pad_vector(f, A.n_pad, mesh))
    (its, reason), = ITS.findall(outs[0][1])
    assert reason == res.reason_name() == "CONVERGED_RTOL"
    assert abs(int(its) - int(res.iterations)) <= 1, (its, int(res.iterations))


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
