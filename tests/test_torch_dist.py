"""Port parity: the distributed stencil path of saddle_point_petsc_tpu_torch
(parallel/mesh.py, halo.py, dist.py, dist_ilu0, the all_reduce
reductions of solvers/krylov.py, make_pc's distributed branches and the
CLI's -dist) against the JAX package's on a (2, 2) mesh of fake CPU
devices, in float64.

One module-scoped gloo world of 4 ranks (2 x 2) runs every distributed
case of the port once: this file, run as a script, is the worker; each
rank joins through the torchrun environment (`init_from_env`), imports no
jax and calls torch.set_num_threads(1), and rank 0 returns the gathered
results. The parent builds the JAX references in process on
`make_mesh(4, shape=(2, 2))` from the same numpy inputs. estimate_lmax
(the Chebyshev PC's -pc_chebyshev_esteig and dist_block_jacobi) starts
from the JAX package's draw of the global vector, handed to the workers.
The CLI runs as 4 `python -m saddle_point_petsc_tpu_torch.cli -dist
-mesh 2,2` processes against the JAX library on (2, 2).

Tolerances:
- halo exchanges (both forms) equal to the JAX ones bit for bit (data
  movement); halo_add to 1e-14; <exchange(x), y> = <x, halo_add(y)> to
  1e-12 relative;
- assembly (unpadded 15 x 15 elements, padded 16 x 16 -> 17 nodes padded
  to 18) to 1e-12 (planes, constraint rows) and 1e-13 (f), masks equal:
  the port takes element coordinates from the serial linspace, the JAX
  package computes i * h, an ulp apart;
- both matvec forms and matmat_field (k = 4) to 1e-12;
- Krylov iteration counts within 1 of the JAX package's (the ranks' sums
  reduce in another order than the JAX psum; tests/test_dist.py allows 1
  against serial), x to 1e-6 relative + 1e-9 (CG, GMRES) and 1e-4 + 1e-8
  on the KKT system (MINRES plateaus amplify the reduction order, ROADMAP
  C, as in tests/test_dist.py);
- a world of one gives the serial route's bits (assembly, matvec, ILU
  iterates);
- `write_vtk_dist` of a padded field: the serial writer's bytes on the
  cropped global field, from rank 0 alone.
"""
import contextlib
import os
import pickle
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu_torch import cli as tcli
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
CG_PCS = ("jacobi", "pbjacobi", "chebyshev")
KKT_OPTS = ["-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "16", "-da_grid_y", "16",
            "-ksp_rtol", "1e-8", "-ksp_converged_reason"]
MAT_SOLVE_OPTS = ["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10"]


def _column_its(history, rnorm0, rtol=1e-10):
    """KSPMatSolve's per-column counts: the history rows above the column's
    threshold (a converged column's norm stays frozen below it)."""
    return (np.asarray(history) > rtol * np.asarray(rnorm0)).sum(0).tolist()


# ---------------------------------------------------------------------------
# the worker: one rank of the 2 x 2 gloo world (no jax)
# ---------------------------------------------------------------------------


def _worker(inp_path, out_path):
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.models import fem
    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.parallel import halo
    from saddle_point_petsc_tpu_torch.solvers import krylov, precond
    from saddle_point_petsc_tpu_torch.solvers.ilu_stencil import DistILU0PC, dist_ilu0
    from saddle_point_petsc_tpu_torch.solvers.ksp import KSP, make_pc
    from saddle_point_petsc_tpu_torch.utils import vtk
    from saddle_point_petsc_tpu_torch.utils.options import Options

    torch.set_num_threads(1)
    with open(inp_path, "rb") as fh:
        inp = pickle.load(fh)

    def jax_draw(template, generator):  # the JAX package's global start vector
        return tuple(torch.tensor(inp["draws"][tuple(a.shape)], dtype=a.dtype) for a in template)

    precond._start_vector = jax_draw
    dev, _ = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    m = pmesh.ProcessMesh.create((2, 2), device=dev)
    out = {}

    def put(name, t):
        g = pmesh.gather_field(t, m)
        if m.rank == 0:
            out[name] = g.numpy()

    def put_result(name, res):
        out[f"{name}_its"] = (res.iterations, res.reason_name())
        for k, leaf in enumerate(res.x if isinstance(res.x, tuple) else (res.x,)):
            if leaf.ndim >= 2:
                put(f"{name}_x{k}", leaf)
            else:
                out[f"{name}_x{k}"] = leaf.numpy()

    x = pmesh.shard_field(inp["x_halo"], m)
    put("halo_exchange", halo.halo_exchange(x, m))
    put("halo_1phase", halo.halo_exchange_1phase(x, m))
    put("halo_add", halo.halo_add(pmesh.shard_field(inp["y_halo"], m), m))

    for nex in (15, 16):
        grid = pd.DistGrid.create(nex, nex, m)
        A, f, mask = pd.assemble_poisson_dist(grid)
        for name, t in (("planes", A.planes), ("f", f), ("mask", mask),
                        ("Bf", pd.assemble_constraints_dist(grid, mask))):
            put(f"{name}{nex}", t)
        out[f"active{nex}"] = A.active_shape
    # the VTK file of a padded field (17 nodes padded to 18): gathered,
    # cropped and written by rank 0 alone
    path = vtk.write_vtk_dist(os.path.join(os.path.dirname(out_path), "dist.vtk"),
                              fem.uniform_node_coords(16, 16), pmesh.shard_field(inp["u18"], m), m)
    writers = [None] * m.size
    dist.all_gather_object(writers, path is not None)
    out["vtk_writers"] = writers
    if path is not None:
        with open(path, "rb") as fh:
            out["vtk_bytes"] = fh.read()

    grid = pd.DistGrid.create(15, 15, m)
    A, f, _ = pd.assemble_poisson_dist(grid)
    xs = pmesh.shard_field(inp["x16"], m)
    put("matvec_overlap", A(xs))
    put("matvec_padded", A.matmat_field(xs[None])[0])  # one field through the SpMM's padded form
    put("matmat", A.matmat_field(pmesh.shard_field(inp["X16"], m)))

    for pc in CG_PCS:
        M = make_pc(pc, A, Options(["-pc_chebyshev_esteig"]))
        put_result(f"cg_{pc}", krylov.cg(A, f, M=M, rtol=1e-10, maxiter=500))
    # KSPMatSolve: the batched dots (_kdot) over the ranks, against the
    # JAX package's and single-right-hand-side CG per column
    B = torch.stack([f, 2.0 * f + 0.1])
    ksp = KSP(Options(MAT_SOLVE_OPTS))
    res = ksp.set_operators(A).set_from_options().mat_solve(B)
    out["mat_solve_its"] = res.converged_reason.tolist(), _column_its(res.history.numpy(), res.rnorm0.numpy())
    put("mat_solve_x", res.x)
    out["mat_solve_single_its"] = [krylov.cg(A, b, M=precond.jacobi(A), rtol=1e-10, maxiter=10000).iterations
                                   for b in B]

    # the KKT system: MINRES + Schur(diag) with the per-patch block-Jacobi
    K, rhs, _ = pd.assemble_saddle_dist(grid, body_force="trig")
    bj = pd.dist_block_jacobi(K.A, iters=4)
    r1, r2 = pmesh.shard_field(inp["x16"], m), pmesh.shard_field(inp["X16"][0], m)
    with krylov.distributed(m):  # global inner products
        out["bj_symmetry"] = [krylov.tdot(bj(r1), r2).item(), krylov.tdot(r1, bj(r2)).item()]
    M = precond.schur_pc(K.A, K.Bf, bj, fact_type="diag")
    put_result("minres_bj", krylov.minres(K, rhs, M=M, rtol=1e-8, maxiter=1000))

    # per-patch ILU(0) under GMRES; make_pc's distributed spellings
    put_result("gmres_ilu", krylov.gmres(A, f, M=dist_ilu0(A, sweeps=6), rtol=1e-8, maxiter=500))
    out["make_pc"] = [type(make_pc(t, A, Options(o))).__name__ for t, o in (
        ("ilu", []), ("bjacobi", []), ("bjacobi", ["-sub_pc_type", "chebyshev"]))]
    assert isinstance(make_pc("bjacobi", A, Options()), DistILU0PC)
    out["dist_pcs"] = [type(make_pc(t, A, Options())).__name__ for t in ("sor", "fieldsplit", "mg")]
    try:
        make_pc("gamg", A, Options())
    except TypeError as e:
        out["gamg_refused"] = ("TypeError", str(e))

    out["jax_loaded"] = sorted(k for k in sys.modules if k == "jax" or k.startswith("saddle_point_petsc_tpu."))
    if m.rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _spawn(argv, n, cwd, timeout=240):
    """Start `python argv` as an n-rank world with the torchrun environment;
    yields a function that waits for the ranks and returns [(rc, stdout,
    stderr)] per rank. The caller may work while the world runs; every
    rank is killed on leaving the block."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []

    def wait():
        outs = []
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            outs.append((p.returncode, so, se))
        return outs

    try:
        for r in range(n):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_RANK": str(r),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "PYTHONPATH": str(REPO),
                   "OMP_NUM_THREADS": "1"}
            procs.append(subprocess.Popen([sys.executable] + argv, cwd=cwd, env=env, text=True,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        yield wait
    finally:
        for p in procs:
            p.kill()


def _launch(argv, n, cwd, timeout=240):
    """Run `python argv` as an n-rank world with the torchrun environment;
    returns [(rc, stdout, stderr)] per rank."""
    with _spawn(argv, n, cwd, timeout) as wait:
        return wait()


@pytest.fixture(scope="module")
def inputs():
    import jax

    rng = np.random.default_rng(0)
    draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16), np.float64))
    return {
        "x_halo": rng.standard_normal((2, 8, 12)),
        "y_halo": rng.standard_normal((2, 12, 16)),  # padded blocks, (2, 2 * 6, 2 * 8)
        "x16": rng.standard_normal((2, 16, 16)),
        "X16": rng.standard_normal((4, 2, 16, 16)),
        "u18": rng.standard_normal((2, 18, 18)),
        "draws": {(2, 16, 16): draw},
    }


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    outs = _launch([str(Path(__file__)), str(tmp / "in.pkl"), str(tmp / "out.pkl")], WORLD, tmp)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    with open(tmp / "out.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def jref(inputs):
    """The JAX package's distributed results on a (2, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from saddle_point_petsc_tpu.parallel import dist as jd
    from saddle_point_petsc_tpu.parallel import halo as jh
    from saddle_point_petsc_tpu.parallel.mesh import GX, GY, make_mesh, shard_field
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu.solvers import precond as jpc
    from saddle_point_petsc_tpu.solvers.ilu_stencil import dist_ilu0 as jdist_ilu0
    from saddle_point_petsc_tpu.solvers.ksp import KSP as JKSP
    from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
    from saddle_point_petsc_tpu.utils.options import Options as JOptions

    mesh = make_mesh(4, shape=(2, 2))
    spec = P(None, GY, GX)

    def smap(fn):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec))

    def put(a, ndim_lead=1):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*([None] * ndim_lead), GY, GX)))

    out = {
        "halo_exchange": np.asarray(smap(jh.halo_exchange)(put(inputs["x_halo"]))),
        "halo_1phase": np.asarray(smap(jh.halo_exchange_1phase)(put(inputs["x_halo"]))),
        "halo_add": np.asarray(smap(jh.halo_add)(put(inputs["y_halo"]))),
    }
    constraints = jax.jit(jd.assemble_constraints_dist, static_argnums=(0,))
    for nex in (15, 16):
        grid = jd.DistGrid.create(nex, nex, mesh)
        A, f, mask = jd.assemble_poisson_dist(grid)
        out.update({f"planes{nex}": np.asarray(A.planes), f"f{nex}": np.asarray(f),
                    f"mask{nex}": np.asarray(mask), f"Bf{nex}": np.asarray(constraints(grid, mask)),
                    f"active{nex}": A.active_shape})

    grid = jd.DistGrid.create(15, 15, mesh)
    A, f, _ = jd.assemble_poisson_dist(grid)
    out["matvec"] = np.asarray(jax.jit(A.matvec_field)(shard_field(jnp.asarray(inputs["x16"]), mesh)))
    out["matmat"] = np.asarray(jax.jit(A.matmat_field)(put(inputs["X16"], 2)))

    def keep(name, res):
        out[f"{name}_its"] = (int(res.iterations), res.reason_name())
        for k, leaf in enumerate(res.x if isinstance(res.x, tuple) else (res.x,)):
            out[f"{name}_x{k}"] = np.asarray(leaf)

    for pc in CG_PCS:
        keep(f"cg_{pc}", jk.cg(A, f, M=jmake_pc(pc, A, JOptions(["-pc_chebyshev_esteig"])),
                               rtol=1e-10, maxiter=500))
    fh = np.asarray(f)
    res = JKSP(JOptions(MAT_SOLVE_OPTS)).set_operators(A).set_from_options().mat_solve(
        put(np.stack([fh, 2.0 * fh + 0.1]), 2))
    out["mat_solve_its"] = np.asarray(res.converged_reason).tolist(), _column_its(res.history, res.rnorm0)
    out["mat_solve_x"] = np.asarray(res.x)
    At, ft, mask_t = jd.assemble_poisson_dist(grid, body_force="trig")
    K = jd.DistSaddleOperator(At, constraints(grid, mask_t))
    rhs = (ft, jnp.zeros((4,)))
    M = jpc.schur_pc(At, K.Bf, jd.dist_block_jacobi(At, iters=4), fact_type="diag")
    keep("minres_bj", jk.minres(K, rhs, M=M, rtol=1e-8, maxiter=1000))
    # the CLI's default saddle route: MINRES + Schur(diag), Jacobi A-block
    keep("minres_jacobi", jk.minres(K, rhs, M=jpc.schur_pc(At, K.Bf, fact_type="diag"), rtol=1e-8,
                                    maxiter=1000))
    keep("gmres_ilu", jk.gmres(A, f, M=jdist_ilu0(A, sweeps=6), rtol=1e-8, maxiter=500))
    try:
        jmake_pc("gamg", A, JOptions())
    except TypeError as e:
        out["gamg_refused"] = ("TypeError", str(e))
    return out


def test_decide_process_grid():
    from saddle_point_petsc_tpu.parallel.mesh import decide_process_grid as jdecide

    for ndev, ny, nx in ((8, 100, 100), (4, 100, 100), (8, 800, 100), (6, 100, 100), (1, 5, 7),
                         (12, 30, 700), (7, None, None)):
        assert pmesh.decide_process_grid(ndev, ny, nx) == jdecide(ndev, ny, nx)


@pytest.mark.parametrize("name", ["halo_exchange", "halo_1phase"])
def test_halo_exchange_matches_jax(world, jref, name):
    np.testing.assert_array_equal(world[name], jref[name])


def test_halo_add_matches_jax_and_is_adjoint(world, jref, inputs):
    np.testing.assert_allclose(world["halo_add"], jref["halo_add"], rtol=0, atol=1e-14)
    lhs = float(np.vdot(world["halo_exchange"], inputs["y_halo"]))
    rhs = float(np.vdot(inputs["x_halo"], world["halo_add"]))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("nex", [15, 16], ids=["unpadded", "padded"])
def test_dist_assembly_matches_jax(world, jref, nex):
    assert world[f"planes{nex}"].shape == jref[f"planes{nex}"].shape  # 16 -> 18 nodes when padded
    np.testing.assert_allclose(world[f"planes{nex}"], jref[f"planes{nex}"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(world[f"f{nex}"], jref[f"f{nex}"], rtol=0, atol=1e-13)
    np.testing.assert_array_equal(world[f"mask{nex}"], jref[f"mask{nex}"])
    assert world[f"active{nex}"] == jref[f"active{nex}"] == (nex + 1, nex + 1)


@pytest.mark.parametrize("nex", [15, 16], ids=["unpadded", "padded"])
def test_dist_constraints_match_jax(world, jref, nex):
    np.testing.assert_allclose(world[f"Bf{nex}"], jref[f"Bf{nex}"], rtol=0, atol=1e-12)


def test_write_vtk_dist_crops_padding(world, inputs, tmp_path):
    """write_vtk_dist on a 17 x 17-node field padded to 18 x 18 over 2 x 2
    ranks: rank 0 alone writes, and its file is the serial writer's on the
    cropped global field, byte for byte."""
    from saddle_point_petsc_tpu_torch.models import fem
    from saddle_point_petsc_tpu_torch.utils import vtk

    assert world["vtk_writers"] == [True, False, False, False]
    ref = vtk.write_vtk(tmp_path / "ref.vtk", fem.uniform_node_coords(16, 16),
                        torch.from_numpy(inputs["u18"][:, :17, :17]))
    assert world["vtk_bytes"] == ref.read_bytes()


@pytest.mark.parametrize("form", ["overlap", "padded"])
def test_dist_matvec_matches_jax(world, jref, form):
    np.testing.assert_allclose(world[f"matvec_{form}"], jref["matvec"], rtol=0, atol=1e-12)


def test_dist_matmat_matches_jax(world, jref):
    np.testing.assert_allclose(world["matmat"], jref["matmat"], rtol=0, atol=1e-12)


def _same_solve(world, jref, name, rtol, atol):
    its_t, reason_t = world[f"{name}_its"]
    its_j, reason_j = jref[f"{name}_its"]
    assert reason_t == reason_j == "CONVERGED_RTOL"
    assert abs(its_t - its_j) <= 1, (its_t, its_j)
    k = 0
    while f"{name}_x{k}" in jref:
        np.testing.assert_allclose(world[f"{name}_x{k}"], jref[f"{name}_x{k}"], rtol=rtol, atol=atol)
        k += 1


@pytest.mark.parametrize("pc", CG_PCS)
def test_dist_cg_matches_jax(world, jref, pc):
    _same_solve(world, jref, f"cg_{pc}", 1e-6, 1e-9)


def test_dist_mat_solve_reduces_over_ranks(world, jref):
    """KSPMatSolve on the distributed operator against the JAX package's on
    (2, 2): the same per-column reasons, per-column counts within 1 and x
    to 1e-6 relative + 1e-9; each column's count also equals the port's
    single-right-hand-side CG's."""
    reasons, its = world["mat_solve_its"]
    reasons_j, its_j = jref["mat_solve_its"]
    assert reasons == reasons_j == [2, 2]
    assert all(abs(a - b) <= 1 for a, b in zip(its, its_j)), (its, its_j)
    np.testing.assert_allclose(world["mat_solve_x"], jref["mat_solve_x"], rtol=1e-6, atol=1e-9)
    assert its == world["mat_solve_single_its"]


def test_dist_minres_kkt_block_jacobi_matches_jax(world, jref):
    lhs, rhs = world["bj_symmetry"]  # the per-patch Chebyshev block solve is symmetric
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
    _same_solve(world, jref, "minres_bj", 1e-4, 1e-8)


def test_dist_gmres_ilu_matches_jax(world, jref):
    _same_solve(world, jref, "gmres_ilu", 1e-6, 1e-9)


def test_make_pc_distributed_types(world):
    assert world["make_pc"] == ["DistILU0PC", "DistILU0PC", "ChebyshevPC"]
    assert world["dist_pcs"] == ["RedBlackSORPC", "FieldSplitPC", "DistMGPC"]
    assert world["jax_loaded"] == []


def test_gamg_on_dist_stencil_raises_the_jax_error(world, jref):
    """-pc_type gamg on a DistStencilOperator raises what the JAX package
    raises: gamg's setup reads no distributed stencil (`_to_scipy`)."""
    assert world["gamg_refused"] == jref["gamg_refused"] == (
        "TypeError", "gamg: unsupported operator DistStencilOperator")


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process (an in-process store)."""
    import torch.distributed as dist

    dev, created = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    assert created
    yield pmesh.ProcessMesh.create(device=dev)
    dist.destroy_process_group()


def test_process_mesh_defaults_to_the_card(world_of_one):
    """ProcessMesh.create() with no device is the card, as the rest of the
    library API: without one it raises rather than run on the CPU unasked.
    A world of one sums nothing: all_reduce hands back its tensor."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.ProcessMesh.create()
    t = torch.ones(3)
    assert world_of_one.all_reduce(t) is t and torch.equal(t, torch.ones(3))


def test_dist_ilu0_one_rank_matches_serial(world_of_one):
    """Per-patch ILU(0) on one rank is the serial stencil ILU(0): the same
    assembly bits, factors and iterates (the JAX counterpart is
    tests/test_dist.py::test_dist_ilu0_one_device_matches_serial), and the
    count equals the JAX package's serial one."""
    from saddle_point_petsc_tpu.models import poisson as jpoisson
    from saddle_point_petsc_tpu.solvers import ilu_stencil as jis
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu_torch.models import poisson
    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.solvers import krylov
    from saddle_point_petsc_tpu_torch.solvers.ilu_stencil import dist_ilu0, stencil_ilu0

    A, f, _ = pd.assemble_poisson_dist(pd.DistGrid.create(31, 31, world_of_one))
    prob = poisson.assemble_poisson(31, 31, device="cpu")
    assert torch.equal(A.planes, prob.A.planes) and torch.equal(f, prob.f)
    x = torch.randn((2, 32, 32), dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    assert torch.equal(A(x), prob.A.matvec_field(x))
    rd = krylov.gmres(A, f, M=dist_ilu0(A, sweeps=6), rtol=1e-8, maxiter=500)
    rs = krylov.gmres(prob.A, prob.f, M=stencil_ilu0(prob.A, sweeps=6), rtol=1e-8, maxiter=500)
    jp = jpoisson.assemble_poisson(31, 31)
    rj = jk.gmres(jp.A, jp.f, M=jis.stencil_ilu0(jp.A, sweeps=6), rtol=1e-8, maxiter=500)
    assert rd.reason_name() == "CONVERGED_RTOL"
    assert rd.iterations == rs.iterations == int(rj.iterations)
    assert torch.equal(rd.x, rs.x)


def test_cli_dist_world_of_one_is_the_serial_route(tmp_path, capsys):
    """BASELINE config 4's solver (MINRES, Schur(diag), per-patch
    block-Jacobi with 4 Chebyshev iterations) with -dist in a world of one
    is the serial route with the PC the 1 x 1 mesh reduces to (Chebyshev
    with -pc_chebyshev_esteig, 4 iterations): the same its= line, solution
    bits and test.vtk bytes, on a grid whose 16 x 12 elements give 17 x 13
    nodes."""
    common = ["-device", "cpu", "-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "17",
              "-da_grid_y", "13", "-ksp_rtol", "1e-8", "-ksp_converged_reason"]
    d = tcli.run(common + ["-dist", "-fieldsplit_inner_pc_type", "bjacobi", "-sub_pc_type", "chebyshev",
                           "-pc_bjacobi_local_its", "4", "-vtk", str(tmp_path / "d.vtk")])
    out_d = capsys.readouterr().out
    s = tcli.run(common + ["-fieldsplit_inner_pc_type", "chebyshev", "-pc_chebyshev_esteig",
                           "-pc_chebyshev_its", "4", "-vtk", str(tmp_path / "s.vtk")])
    out_s = capsys.readouterr().out
    assert d.rc == s.rc == 0 and out_d == out_s and "its=" in out_d
    assert torch.equal(d.result.x[0], s.result.x[0]) and torch.equal(d.result.x[1], s.result.x[1])
    assert (tmp_path / "d.vtk").read_bytes() == (tmp_path / "s.vtk").read_bytes()


def test_cli_dist_four_ranks_matches_jax(tmp_path, jref):
    """`python -m saddle_point_petsc_tpu_torch.cli -dist -mesh 2,2` in a
    spawned 4-rank gloo world: rank 0 alone prints the its= line and the
    reason, which equal the JAX library's MINRES + Schur(diag) on (2, 2);
    one test.vtk, whose geometry equals the JAX writer's and whose values
    match the JAX solution to 1e-8 of max|u| (as tests/test_torch_cli.py)."""
    from saddle_point_petsc_tpu.models import fem as jfem
    from saddle_point_petsc_tpu.utils import vtk as jvtk

    argv = ["-m", "saddle_point_petsc_tpu_torch.cli", "-device", "cpu", "-dist", "-mesh", "2,2"] + KKT_OPTS
    outs = _launch(argv, WORLD, tmp_path)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    assert all(so == "" for _, so, _ in outs[1:])
    its, reason = jref["minres_jacobi_its"]
    out0 = outs[0][1]
    assert f"its={its}, reason={reason}" in out0
    assert f"Linear solve CONVERGED due to {reason} iterations {its}" in out0
    jpath = tmp_path / "jax.vtk"
    jvtk.write_vtk(jpath, jfem.uniform_node_coords(15, 15), jref["minres_jacobi_x0"])
    lt, lj = (tmp_path / "test.vtk").read_text().split("\n"), jpath.read_text().split("\n")
    head = lj.index("POINT_DATA 256")
    assert lt[:head] == lj[:head] and len(lt) == len(lj)
    vt, vj = (np.array([float(v) for ln in lines[head:] if ln[:1] not in "PVSL" for v in ln.split()])
              for lines in (lt, lj))
    assert np.max(np.abs(vt - vj)) <= 1e-8 * np.max(np.abs(vj))


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
