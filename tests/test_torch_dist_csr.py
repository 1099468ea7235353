"""Port parity: the row-partitioned DistAIJ of saddle_point_petsc_tpu_torch
(parallel/dist_csr.py, ProcessMesh.all_to_all, make_pc's DistAIJ branches,
KSP.mat_solve and refinement on it, and the CLI's -mat_type aij -dist)
against the JAX package's on `dist_csr.make_mesh_1d(4)` of fake CPU
devices, in float64.

One module-scoped gloo world of 4 ranks runs every distributed case of the
port once: this file, run as a script, is the worker (the launcher is
tests/test_torch_dist.py's `_launch`); each rank imports no jax, and rank
0 returns every rank's results, gathered. The parent builds the JAX
references in process from the same numpy inputs (made by
np.random.default_rng with a fixed seed). `dist_aij_block_jacobi`'s
estimate_lmax starts from the JAX package's draw of the global vector,
handed to the workers. The CLI runs as 4 `python -m
saddle_point_petsc_tpu_torch.cli -dist -mat_type aij` processes against
the JAX library on make_mesh_1d(4).

Tolerances:
- the plans (ELL blocks, send plan, band offsets and data, n_pad,
  max_send), `diagonal`, `to_scipy` and `to_scipy_rows` equal the JAX
  package's exactly (host numpy on the same inputs);
- matvec and matmat to 1e-12 against the JAX package and scipy (rows are
  summed in another order);
- Krylov counts within 1 of the JAX package's (the ranks' partial dots
  reduce in another order than the JAX psum, as tests/test_torch_dist.py),
  x to 1e-6 relative + 1e-9; KSPMatSolve's per-column counts equal;
- refinement reaches a true relative residual of 1e-10 (the twin of
  tests/test_dist_csr.py::test_dist_aij_refined_reaches_1e10);
- the CLI: the same its= line, VTK geometry bytes equal and values within
  1e-8 of max|u| (as tests/test_torch_cli.py).
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

from test_torch_dist import _launch, world_of_one  # noqa: F401  (a fixture)

from saddle_point_petsc_tpu_torch import cli as tcli
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh

WORLD = 4
PLAN_FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx", "dia_data")
MAT_SOLVE_OPTS = ["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10"]
CLI_OPTS = ["-mat_type", "aij", "-da_grid_x", "17", "-da_grid_y", "13", "-ksp_type", "cg", "-pc_type", "bjacobi",
            "-ksp_rtol", "1e-8", "-ksp_converged_reason"]
SOLVES = ("cg_jacobi", "cg_bjacobi", "cg_ilu", "gmres_ilu")


def _poisson2d(nx, ny):
    """Scalar 5-point Laplacian (natural row-major ordering)."""
    tx = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    ty = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (ny, ny))
    return (sps.kron(sps.identity(ny), tx) + sps.kron(ty, sps.identity(nx))).tocsr()


def _column_its(history, rnorm0, rtol=1e-10):
    """KSPMatSolve's per-column counts: the history rows above the column's
    threshold (a converged column's norm stays frozen below it)."""
    return (np.asarray(history) > rtol * np.asarray(rnorm0)).sum(0).tolist()


# ---------------------------------------------------------------------------
# the worker: one rank of the 4-rank gloo world (no jax)
# ---------------------------------------------------------------------------


def _worker(inp_path, out_path):
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.parallel import dist_csr as dc
    from saddle_point_petsc_tpu_torch.solvers import krylov, precond, refine
    from saddle_point_petsc_tpu_torch.solvers.ksp import KSP, make_pc
    from saddle_point_petsc_tpu_torch.utils.options import Options

    torch.set_num_threads(1)
    with open(inp_path, "rb") as fh:
        inp = pickle.load(fh)

    def jax_draw(template, generator):  # the JAX package's global start vector
        return tuple(torch.tensor(inp["draws"][tuple(a.shape)], dtype=a.dtype) for a in template)

    precond._start_vector = jax_draw
    dev, _ = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    m = dc.make_mesh_1d(device=dev)
    me = {}  # this rank's results

    def plan(A):
        return {"diag_cols": A.diag_cols_t.T.numpy(), "diag_vals": A.diag_vals_t.T.numpy(),
                "off_cols": A.off_cols_t.T.numpy(), "off_vals": A.off_vals_t.T.numpy(),
                "send_idx": A.send_idx.numpy(),
                "dia_data": None if A.dia_data is None else A.dia_data.numpy(),
                "dia_offsets": A.dia_offsets, "n_pad": A.n_pad, "max_send": A.max_send, "nnz": A.nnz,
                "ghost_count": A.ghost_count}

    def rows(name, t):  # the global vector, gathered
        me[name] = pmesh.gather_rows(t, m).numpy()

    def put_result(name, res):
        me[f"{name}_its"] = (res.iterations, res.reason_name())
        rows(f"{name}_x", res.x)

    # plans and products
    mats = {"rand5": inp["rand5"], "q1": inp["q1"], "rect": inp["rect"]}
    for name, a in mats.items():
        A = dc.dist_aij_from_scipy(a, m)
        me[f"plan_{name}"] = plan(A)
        x = dc.pad_vector(inp[f"x_{name}"], A.n_pad_c, m)
        rows(f"matvec_{name}", A.matvec(x))
        me[f"rows_{name}"] = A.to_scipy_rows()
        if name != "rect":
            rows(f"diagonal_{name}", A.diagonal())
    me["to_scipy"] = dc.dist_aij_from_scipy(inp["rand5"], m).to_scipy()
    q1 = inp["q1"]
    for dia in ("auto", "off"):
        A = dc.dist_aij_from_scipy(q1, m, dia=dia)
        me[f"has_dia_{dia}"] = A.dia_data is not None
        rows(f"matvec_q1_{dia}", A.matvec(dc.pad_vector(inp["x_q1"], A.n_pad, m)))
        rows(f"matmat_q1_{dia}", A.matmat(dc.pad_vector(inp["X_q1"], A.n_pad, m)))
    # dist_aij_to_dia on an ELL build gives from_scipy's bands
    Ae, Aa = dc.dist_aij_from_scipy(q1, m, dia="off"), dc.dist_aij_from_scipy(q1, m, dia="force")
    Ad = dc.dist_aij_to_dia(Ae)
    me["to_dia_equal"] = Ad.dia_offsets == Aa.dia_offsets and torch.equal(Ad.dia_data, Aa.dia_data)
    perm = dc.local_rcm_permutation(inp["shuffled"], WORLD)
    me["rcm_perm"] = perm
    Ap = dc.dist_aij_from_scipy(inp["shuffled"][perm][:, perm], m, dia="force")
    me["plan_rcm"] = plan(Ap)
    rows("matvec_rcm", Ap.matvec(dc.pad_vector(inp["x_q1"], Ap.n_pad, m)))
    me["ghost_counts"] = [dc.dist_aij_from_scipy(_poisson2d(16, ny), m).ghost_count for ny in (32, 64, 256)]

    # ProcessMesh.all_to_all: chunk r of rank s's input lands as chunk s on rank r
    send = torch.arange(2 * WORLD, dtype=torch.float64) + 100 * m.rank
    me["all_to_all"] = m.all_to_all(send).numpy()
    me["all_to_all_async"] = m.all_to_all(send, async_op=True).wait().numpy()

    # triplets: each rank holds a quarter of the shuffled duplicate-split COO
    r, c, v = (np.array_split(inp["coo"][k], WORLD)[m.rank] for k in range(3))
    n_coo = inp["coo_n"]
    A = dc.dist_aij_from_coo(r, c, v, n_coo, m)
    ref = dc.dist_aij_from_scipy(sps.coo_matrix((inp["coo"][2], (inp["coo"][0], inp["coo"][1])),
                                                shape=(n_coo, n_coo)).tocsr(), m)
    me["coo_plan"], me["coo_ref_plan"] = plan(A), plan(ref)
    try:
        dc.dist_aij_from_coo(r, c, v, n_coo, m, cap=1)
        me["coo_overflow"] = None
    except ValueError as e:
        me["coo_overflow"] = str(e)

    # solves on the Q1 operator
    A = dc.dist_aij_from_scipy(q1, m)
    b = dc.pad_vector(inp["b_q1"], A.n_pad, m)
    put_result("cg_jacobi", krylov.cg(A, b, M=precond.jacobi(A), rtol=1e-10, maxiter=2000))
    bj = dc.dist_aij_block_jacobi(A, iters=6)
    r1, r2 = (dc.pad_vector(inp[k], A.n_pad, m) for k in ("r1", "r2"))
    with krylov.distributed(m, A.dist_leaves):
        me["bj_symmetry"] = [krylov.tdot(bj(r1), r2).item(), krylov.tdot(r1, bj(r2)).item()]
    put_result("cg_bjacobi", krylov.cg(A, b, M=bj, rtol=1e-10, maxiter=2000))
    ilu = dc.dist_aij_ilu0(A, sweeps=6)
    put_result("cg_ilu", krylov.cg(A, b, M=ilu, rtol=1e-10, maxiter=2000))
    put_result("gmres_ilu", krylov.gmres(A, b, M=ilu, rtol=1e-10, maxiter=2000))

    # R1: a 1-D DistAIJ vector's norm inside its operator's distribution
    @krylov.reduces_over_ranks
    def norm_of(op, v):
        return krylov.tnorm(v).item()

    me["r1_tnorm"] = norm_of(A, b)

    # KSPMatSolve (R2: the bound matmat_batch carries the mesh)
    B = dc.pad_vector(inp["B_q1"], A.n_pad, m).T.contiguous()
    res = KSP(Options(MAT_SOLVE_OPTS)).set_operators(A).set_from_options().mat_solve(B)
    me["mat_solve_its"] = res.converged_reason.tolist(), _column_its(res.history.numpy(), res.rnorm0.numpy())
    rows("mat_solve_x", res.x.T)

    # make_pc's DistAIJ spellings
    me["make_pc"] = [type(make_pc(t, A, Options(o))).__name__ for t, o in (
        ("none", []), ("jacobi", []), ("chebyshev", []), ("ilu", []), ("bjacobi", []),
        ("bjacobi", ["-sub_pc_type", "chebyshev"]), ("gamg", []), ("gamg", ["-pc_gamg_setup", "stream"]))]
    refused = {}
    for t in ("sor", "fieldsplit"):
        try:
            make_pc(t, A, Options())
        except ValueError as e:
            refused[t] = (type(e).__name__, str(e))
    me["refused"] = refused

    # refinement (R3): f32 CG + ILU(0) inner solves, an f64 DistAIJ residual
    a64 = inp["refine_a"]
    A64 = dc.dist_aij_from_scipy(a64, m)
    A32 = dc.dist_aij_from_scipy(a64, m, dtype=torch.float32)
    pc = dc.dist_aij_ilu0(A32, sweeps=6)

    def inner(rr):
        out = krylov.cg(A32, rr, M=pc, rtol=1e-5, maxiter=500)
        return out.x, out.iterations

    out = refine.solve_refined(A32, dc.pad_vector(inp["refine_b"], A64.n_pad, m), inner, rtol=1e-10,
                               max_cycles=10, matvec_df=A64)
    me["refine"] = (out.rnorm, out.rnorm0, out.cycles)
    rows("refine_x", out.x)

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
    import jax

    from saddle_point_petsc_tpu.models import poisson as jpoisson
    from saddle_point_petsc_tpu.ops import sparse as jsp

    rng = np.random.default_rng(8)
    # a nonsymmetric 5-point pattern on a 9 x 7 grid (63 rows: padded to 64)
    p = _poisson2d(9, 7).tocoo()
    rand5 = sps.csr_matrix((rng.standard_normal(p.nnz) + 4.0 * (p.row == p.col), (p.row, p.col)), shape=p.shape)
    q1 = jsp.csr_to_scipy(jpoisson.assemble_poisson_csr(16, 12)[0]).tocsr()  # 17 x 13 nodes: 442 rows
    n = q1.shape[0]
    rect = sps.random(50, 23, density=0.2, random_state=np.random.RandomState(3), format="csr")
    shuf = np.arange(n)
    n_loc = -(-n // WORLD)
    for s in range(WORLD):  # shuffle within each rank's rows
        lo, hi = s * n_loc, min((s + 1) * n_loc, n)
        shuf[lo:hi] = lo + rng.permutation(hi - lo)
    coo = _poisson2d(8, 6).tocoo()
    r = np.concatenate([coo.row, coo.row]).astype(np.int32)
    c = np.concatenate([coo.col, coo.col]).astype(np.int32)
    v = np.concatenate([coo.data * 0.6, coo.data * 0.4])
    order = rng.permutation(len(r))
    n_pad = -(-n // WORLD) * WORLD
    draws = {(k,): np.asarray(jax.random.normal(jax.random.PRNGKey(0), (k,), np.float64))
             for k in (n_pad, 1600)}
    return {
        "rand5": rand5, "q1": q1, "rect": rect, "shuffled": q1[shuf][:, shuf].tocsr(),
        "x_rand5": rng.standard_normal(63), "x_q1": rng.standard_normal(n), "x_rect": rng.standard_normal(23),
        "X_q1": rng.standard_normal((n, 4)), "B_q1": rng.standard_normal((n, 2)),
        "b_q1": rng.standard_normal(n), "r1": rng.standard_normal(n), "r2": rng.standard_normal(n),
        "coo": (r[order], c[order], v[order]), "coo_n": 48,
        "refine_a": _poisson2d(40, 40).astype(np.float64), "refine_b": rng.standard_normal(1600),
        "draws": draws,
    }


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_csr")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    outs = _launch([str(Path(__file__)), str(tmp / "in.pkl"), str(tmp / "out.pkl")], WORLD, tmp)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    with open(tmp / "out.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def jref(inputs):
    """The JAX package's DistAIJ results on make_mesh_1d(4)."""
    import jax

    from saddle_point_petsc_tpu.parallel import dist_csr as jdc
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu.solvers import precond as jpc
    from saddle_point_petsc_tpu.solvers.ksp import KSP as JKSP
    from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
    from saddle_point_petsc_tpu.utils.options import Options as JOptions

    mesh = jdc.make_mesh_1d(WORLD)
    out = {"mesh": mesh}

    def plan(A):
        g = {k: np.asarray(getattr(A, k)) if getattr(A, k) is not None else None for k in PLAN_FIELDS}
        n_loc = A.n_loc
        per = []
        for s in range(WORLD):
            sl = slice(s * n_loc, (s + 1) * n_loc)
            per.append({"diag_cols": g["diag_cols"][sl], "diag_vals": g["diag_vals"][sl],
                        "off_cols": g["off_cols"][sl], "off_vals": g["off_vals"][sl],
                        "send_idx": g["send_idx"][s],
                        "dia_data": None if g["dia_data"] is None else g["dia_data"][:, sl],
                        "dia_offsets": A.dia_offsets, "n_pad": A.n_pad, "max_send": A.max_send, "nnz": A.nnz,
                        "ghost_count": A.ghost_count})
        return per

    for name in ("rand5", "q1", "rect"):
        A = jdc.dist_aij_from_scipy(inputs[name], mesh)
        out[f"plan_{name}"] = plan(A)
        x = jdc.pad_vector(inputs[f"x_{name}"], A.n_pad_c, mesh)
        out[f"matvec_{name}"] = np.asarray(jax.jit(A.matvec)(x))
        out[f"rows_{name}"] = [A.to_scipy_rows(s) for s in range(WORLD)]
        if name != "rect":
            out[f"diagonal_{name}"] = np.asarray(A.diagonal())
    out["to_scipy"] = jdc.dist_aij_from_scipy(inputs["rand5"], mesh).to_scipy()
    for dia in ("auto", "off"):
        A = jdc.dist_aij_from_scipy(inputs["q1"], mesh, dia=dia)
        out[f"matvec_q1_{dia}"] = np.asarray(jax.jit(A.matvec)(jdc.pad_vector(inputs["x_q1"], A.n_pad, mesh)))
        out[f"matmat_q1_{dia}"] = np.asarray(jax.jit(A.matmat)(jdc.pad_vector(inputs["X_q1"], A.n_pad, mesh)))
    perm = jdc.local_rcm_permutation(inputs["shuffled"], WORLD)
    out["rcm_perm"] = perm
    Ap = jdc.dist_aij_from_scipy(inputs["shuffled"][perm][:, perm], mesh, dia="force")
    out["plan_rcm"] = plan(Ap)
    out["matvec_rcm"] = np.asarray(jax.jit(Ap.matvec)(jdc.pad_vector(inputs["x_q1"], Ap.n_pad, mesh)))

    A = jdc.dist_aij_from_scipy(inputs["q1"], mesh)
    b = jdc.pad_vector(inputs["b_q1"], A.n_pad, mesh)

    def keep(name, res):
        out[f"{name}_its"] = (int(res.iterations), res.reason_name())
        out[f"{name}_x"] = np.asarray(res.x)

    keep("cg_jacobi", jk.cg(A, b, M=jpc.jacobi(A), rtol=1e-10, maxiter=2000))
    keep("cg_bjacobi", jk.cg(A, b, M=jdc.dist_aij_block_jacobi(A, iters=6), rtol=1e-10, maxiter=2000))
    ilu = jdc.dist_aij_ilu0(A, sweeps=6)
    keep("cg_ilu", jk.cg(A, b, M=ilu, rtol=1e-10, maxiter=2000))
    keep("gmres_ilu", jk.gmres(A, b, M=ilu, rtol=1e-10, maxiter=2000))
    Bj = jdc.pad_vector(inputs["B_q1"], A.n_pad, mesh).T
    res = JKSP(JOptions(MAT_SOLVE_OPTS)).set_operators(A).set_from_options().mat_solve(Bj)
    out["mat_solve_its"] = np.asarray(res.converged_reason).tolist(), _column_its(res.history, res.rnorm0)
    out["mat_solve_x"] = np.asarray(res.x).T
    refused = {}
    for t in ("sor", "fieldsplit"):
        try:
            jmake_pc(t, A, JOptions())
        except ValueError as e:
            refused[t] = ("ValueError", str(e))
    out["refused"] = refused
    return out


def _rows_of(world, key):
    return [w[key] for w in world]


@pytest.mark.parametrize("name", ["rand5", "q1", "rect", "rcm"])
def test_plans_equal_the_jax_shards(world, jref, name):
    """Every rank's diag/off-diag ELL blocks, send plan, bands and statics
    equal the JAX package's shard of them exactly."""
    for rank, (mine, ref) in enumerate(zip(_rows_of(world, f"plan_{name}"), jref[f"plan_{name}"])):
        for key, want in ref.items():
            got = mine[key]
            if isinstance(want, np.ndarray):
                assert got.shape == want.shape, (rank, key)
                np.testing.assert_array_equal(got, want, err_msg=f"rank {rank} {key}")
            else:
                assert got == want, (rank, key, got, want)


def test_q1_bands_pass_the_auto_test(world, jref):
    """The interleaved 2-dof 9-point pattern attaches the banded copy under
    dia="auto" and not under "off"; dist_aij_to_dia of the ELL build gives
    the bands of dia="force"."""
    for w in world:
        assert w["has_dia_auto"] and not w["has_dia_off"] and w["to_dia_equal"]
    assert len(jref["plan_q1"][0]["dia_offsets"]) == 21  # 7 dof offsets around each node offset 0, +-1 row


@pytest.mark.parametrize("name", ["rand5", "q1", "rect", "q1_auto", "q1_off", "rcm"])
def test_matvec_matches_jax_and_scipy(world, jref, inputs, name):
    got = world[0][f"matvec_{name}"]
    np.testing.assert_allclose(got, jref[f"matvec_{name}"], rtol=0, atol=1e-12)
    base = name.split("_")[0]
    if base == "rcm":
        return
    a = inputs[base]
    np.testing.assert_allclose(got[: a.shape[0]], a @ inputs[f"x_{base}"], rtol=0, atol=1e-12)
    # square: identity padding rows act on a zero-padded vector; rectangular: empty rows
    np.testing.assert_array_equal(got[a.shape[0]:], 0.0)


@pytest.mark.parametrize("dia", ["auto", "off"])
def test_matmat_matches_jax_and_scipy(world, jref, inputs, dia):
    got = world[0][f"matmat_q1_{dia}"]
    np.testing.assert_allclose(got, jref[f"matmat_q1_{dia}"], rtol=0, atol=1e-12)
    a = inputs["q1"]
    np.testing.assert_allclose(got[: a.shape[0]], a @ inputs["X_q1"], rtol=0, atol=1e-12)


def test_local_rcm_permutation_matches_jax(world, jref):
    np.testing.assert_array_equal(world[0]["rcm_perm"], jref["rcm_perm"])


def test_setup_helpers_are_exact(world, jref):
    """diagonal, to_scipy (on every rank) and each rank's to_scipy_rows
    equal the JAX package's exactly."""
    for name in ("rand5", "q1"):
        np.testing.assert_array_equal(world[0][f"diagonal_{name}"], jref[f"diagonal_{name}"])
    for name in ("rand5", "q1", "rect"):
        for rank, (mine, ref) in enumerate(zip(_rows_of(world, f"rows_{name}"), jref[f"rows_{name}"])):
            assert mine.shape == ref.shape and (mine != ref).nnz == 0, (name, rank)
    for w in world:
        assert (w["to_scipy"] != jref["to_scipy"]).nnz == 0 and w["to_scipy"].shape == (63, 63)


def test_comm_volume_independent_of_n(world):
    """The scaling invariant of tests/test_dist_csr.py: on 4 ranks the ghost
    count of a 16-wide 5-point grid stays constant as ny grows 8x, and is a
    tiny fraction of the vector at the largest."""
    ghosts = world[0]["ghost_counts"]
    assert ghosts[0] == ghosts[1] == ghosts[2] < 16 * 256 / 16


def test_all_to_all_routes_chunks(world):
    """Chunk r of rank s's input lands as chunk s of rank r's output, in
    both forms."""
    for r, w in enumerate(world):
        want = np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * s for s in range(WORLD)])
        np.testing.assert_array_equal(w["all_to_all"], want)
        np.testing.assert_array_equal(w["all_to_all_async"], want)


def test_from_coo_matches_from_scipy(world):
    """Duplicated, shuffled triplets spread over the ranks reassemble to the
    plan of the summed matrix (the exact largest bucket as the default
    capacity); a capacity of 1 raises on every rank."""
    for w in world:
        for key, want in w["coo_ref_plan"].items():
            got = w["coo_plan"][key]
            if isinstance(want, np.ndarray):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
            else:
                assert got == want
        assert "overflow: bucket capacity 1 too small" in w["coo_overflow"]


@pytest.mark.parametrize("name", SOLVES)
def test_solves_match_jax(world, jref, name):
    its_t, reason_t = world[0][f"{name}_its"]
    its_j, reason_j = jref[f"{name}_its"]
    assert reason_t == reason_j == "CONVERGED_RTOL"
    assert abs(its_t - its_j) <= 1, (its_t, its_j)
    np.testing.assert_allclose(world[0][f"{name}_x"], jref[f"{name}_x"], rtol=1e-6, atol=1e-9)
    assert all(w[f"{name}_its"] == world[0][f"{name}_its"] for w in world)  # every rank takes the same branches


def test_block_jacobi_is_symmetric(world):
    lhs, rhs = world[0]["bj_symmetry"]
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_tnorm_of_rows_is_the_global_norm(world, inputs):
    """R1: inside its operator's distribution a 1-D DistAIJ vector's norm
    sums over the ranks: the global norm on every rank."""
    want = np.linalg.norm(inputs["b_q1"])
    for w in world:
        np.testing.assert_allclose(w["r1_tnorm"], want, rtol=1e-14)


def test_mat_solve_counts_equal_jax(world, jref):
    """R2: KSPMatSolve on a DistAIJ sums its per-column dots over the ranks:
    per-column reasons and counts equal the JAX package's."""
    assert world[0]["mat_solve_its"] == jref["mat_solve_its"]
    assert jref["mat_solve_its"][0] == [2, 2]
    np.testing.assert_allclose(world[0]["mat_solve_x"], jref["mat_solve_x"], rtol=1e-6, atol=1e-9)


def test_make_pc_spellings(world, jref):
    assert world[0]["make_pc"] == ["IdentityPC", "JacobiPC", "ChebyshevPC", "DistAIJILU0PC", "DistAIJILU0PC",
                                   "ChebyshevPC", "DistAMGPC", "DistAMGPC"]
    refused = world[0]["refused"]
    assert sorted(refused) == ["fieldsplit", "sor"]
    for t in ("sor", "fieldsplit"):
        assert refused[t] == jref["refused"][t]


def test_refined_reaches_1e10(world, inputs):
    """R3: f32 inner solves with an f64 DistAIJ residual reach 1e-10, with
    the residual norms summed over the ranks (rnorm0 is the global norm of
    b); the twin of test_dist_aij_refined_reaches_1e10."""
    import scipy.sparse.linalg as spla

    for w in world:
        rnorm, rnorm0, cycles = w["refine"]
        np.testing.assert_allclose(rnorm0, np.linalg.norm(inputs["refine_b"]), rtol=1e-14)
        assert rnorm <= 1e-10 * rnorm0 and cycles >= 2
    x = world[0]["refine_x"][:1600]
    np.testing.assert_allclose(x, spla.spsolve(inputs["refine_a"].tocsc(), inputs["refine_b"]), atol=1e-7)


def test_port_never_imports_jax(world):
    assert all(w["jax_loaded"] == [] for w in world)


def test_make_mesh_1d_defaults_to_the_card(world_of_one):  # noqa: F811  (the imported fixture)
    """make_mesh_1d() with no device is the card, as the rest of the library
    API: without one it raises; with device="cpu" it is a (1, 1) mesh."""
    from saddle_point_petsc_tpu_torch.parallel import dist_csr as dc

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dc.make_mesh_1d()
    assert dc.make_mesh_1d(device="cpu").shape == (1, 1)


ITS = re.compile(r"its=\d+, reason=\w+")


@pytest.mark.parametrize("mat_type", ["aij", "dia", "bdia"])
def test_cli_world_of_one_is_the_serial_route(capsys, mat_type):
    """-mat_type aij|dia|bdia -dist in a world of one (a DistAIJ with its
    banded copy) gives the serial route's its= line at 65^2 f64."""
    import torch.distributed as dist

    argv = ["-device", "cpu", "-mat_type", mat_type, "-da_grid_x", "65", "-da_grid_y", "65", "-ksp_type", "cg",
            "-ksp_rtol", "1e-8", "-no_vtk"]
    d = tcli.run(argv + ["-dist"])
    its_d = ITS.findall(capsys.readouterr().out)
    s = tcli.run(argv)
    assert d.rc == s.rc == 0 and len(its_d) == 1 and its_d == ITS.findall(capsys.readouterr().out)
    assert type(d.problem.A).__name__ == "DistAIJ" and not dist.is_initialized()
    np.testing.assert_allclose(d.result.x[: s.result.x.shape[0]].numpy(), s.result.x.numpy(), rtol=0,
                               atol=1e-9 * s.result.x.abs().max().item())


def test_cli_four_ranks_matches_jax(tmp_path, jref):
    """`python -m saddle_point_petsc_tpu_torch.cli -dist -mat_type aij` in a
    spawned 4-rank gloo world against the JAX library on make_mesh_1d(4)
    (CG + per-rank ILU(0)): rank 0 alone prints, its its= line equals the
    JAX solve's; one test.vtk, whose geometry equals the JAX writer's and
    whose values match the JAX solution to 1e-8 of max|u|."""
    from saddle_point_petsc_tpu.models import poisson as jpoisson
    from saddle_point_petsc_tpu.ops import sparse as jsp
    from saddle_point_petsc_tpu.ops.stencil import flat_to_field
    from saddle_point_petsc_tpu.parallel import dist_csr as jdc
    from saddle_point_petsc_tpu.solvers.ksp import KSP as JKSP
    from saddle_point_petsc_tpu.utils import vtk as jvtk
    from saddle_point_petsc_tpu.utils.options import Options as JOptions

    argv = ["-m", "saddle_point_petsc_tpu_torch.cli", "-device", "cpu", "-dist"] + CLI_OPTS
    outs = _launch(argv, WORLD, tmp_path)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    assert all(so == "" for _, so, _ in outs[1:])
    csr, f, _, coords = jpoisson.assemble_poisson_csr(16, 12)
    mesh = jref["mesh"]
    A = jdc.dist_aij_from_scipy(jsp.csr_to_scipy(csr), mesh, dtype="float64")
    ksp = JKSP(JOptions(CLI_OPTS)).set_operators(A).set_from_options()
    res = ksp.solve(jdc.pad_vector(f, A.n_pad, mesh))
    its, reason = int(res.iterations), res.reason_name()
    out0 = outs[0][1]
    assert f"its={its}, reason={reason}" in out0 and reason == "CONVERGED_RTOL"
    assert f"Linear solve CONVERGED due to {reason} iterations {its}" in out0
    jpath = tmp_path / "jax.vtk"
    jvtk.write_vtk(jpath, coords, flat_to_field(np.asarray(res.x)[: csr.shape[0]], 13, 17))
    lt, lj = (tmp_path / "test.vtk").read_text().split("\n"), jpath.read_text().split("\n")
    head = lj.index("POINT_DATA 221")
    assert lt[:head] == lj[:head] and len(lt) == len(lj)
    vt, vj = (np.array([float(v) for ln in lines[head:] if ln[:1] not in "PVSL" for v in ln.split()])
              for lines in (lt, lj))
    assert np.max(np.abs(vt - vj)) <= 1e-8 * np.max(np.abs(vj))


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
