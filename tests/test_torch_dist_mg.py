"""Port parity: the distributed red-black SOR, fieldsplit and geometric
multigrid of saddle_point_petsc_tpu_torch (`precond.sor` and
`dist_fieldsplit` on a DistStencilOperator, `multigrid.mg_pc_dist`, and
make_pc's and the CLI's -pc_type sor|fieldsplit|mg -dist) against the
JAX package's on a (2, 2) mesh of fake CPU devices, in float64.

One module-scoped gloo world of 4 ranks (2 x 2) runs every distributed
case of the port once, as in tests/test_torch_dist.py: this file, run as
a script, is the worker (no jax); rank 0 returns the gathered results.
The workers run while the parent builds the JAX references on
`make_mesh(4, shape=(2, 2))` from the same numpy inputs. The grid is the
padded one of the JAX package's own MG parity test: 32 x 32 elements,
33 nodes padded to 34, so every MG level's patches are ragged (17 and
16 nodes, then 9 and 8, then 5 and 4) and the 5 x 5 coarsest level is
gathered; on a 1 x 4 mesh over 17 nodes a rank would hold one column of
the 9-node level, so that level is gathered and the V-cycle finishes on
the serial hierarchy below it. estimate_lmax (the Chebyshev smoother)
starts from the JAX package's draw of each level's global vector, handed
to the workers.

Tolerances: Krylov iteration counts equal to the JAX package's; one PC
apply to 1e-12 of max|z|; x to 1e-10 of max|x| (1e-9 on the KKT system,
whose MINRES plateaus amplify the order of the ranks' sums, ROADMAP C).
A world of one runs the same per-rank code and gives the serial PCs'
applies to 1e-14 and their iteration counts.
"""
import pickle
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from test_torch_dist import _launch, _spawn, world_of_one  # noqa: F401  (a fixture)

WORLD = 4
NEX = 32  # 33 nodes a side, padded to 34 on the 2 x 2 mesh
SMOOTHERS = ("sor", "sor-fb", "chebyshev", "jacobi")
SOR_ORDERS = ("symmetric", "forward", "backward")
FS_TYPES = ("additive", "multiplicative")
# the Schur A-block of BASELINE config 5's solver
KKT_OPTS = ["-ksp_type", "minres", "-pc_type", "fieldsplit", "-fieldsplit_inner_pc_type", "mg",
            "-pc_mg_smoother", "chebyshev"]


def _draw(draws, template):
    """The JAX package's estimate_lmax start vector for each leaf's shape."""
    def one(a):
        return torch.tensor(draws[tuple(a.shape)], dtype=a.dtype)

    return tuple(one(a) for a in template) if isinstance(template, tuple) else one(template)


# ---------------------------------------------------------------------------
# the worker: one rank of the 2 x 2 gloo world (no jax)
# ---------------------------------------------------------------------------


def _worker(inp_path, out_path):
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.solvers import krylov, precond
    from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc
    from saddle_point_petsc_tpu_torch.utils.options import Options

    torch.set_num_threads(1)
    with open(inp_path, "rb") as fh:
        inp = pickle.load(fh)
    precond._start_vector = lambda template, generator: _draw(inp["draws"], template)
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

    grid = pd.DistGrid.create(NEX, NEX, m)
    A, f, _ = pd.assemble_poisson_dist(grid)
    r = pmesh.shard_field(inp["r"], m)
    for order in SOR_ORDERS:
        put(f"sor_{order}", precond.sor(A, order=order)(r))
    put_result("cg_sor", krylov.cg(A, f, M=make_pc("sor", A), rtol=1e-10, maxiter=500))
    for fs in FS_TYPES:
        M = make_pc("fieldsplit", A, Options(["-pc_fieldsplit_type", fs]))
        put(f"fs_{fs}", M(r))
        solve = krylov.cg if fs == "additive" else krylov.gmres  # multiplicative is not symmetric
        put_result(f"fs_{fs}_solve", solve(A, f, M=M, rtol=1e-10, maxiter=500))
    for sm in SMOOTHERS:
        M = make_pc("mg", A, Options(["-pc_mg_smoother", sm]))
        put(f"mg_{sm}", M(r))
        put_result(f"cg_mg_{sm}", krylov.cg(A, f, M=M, rtol=1e-10, maxiter=100))
    # the patches of every distributed level, and the gathered grid
    patches = [None] * m.size
    dist.all_gather_object(patches, [lvl.A.local_shape for lvl in M.levels])
    out["mg_patches"], out["mg_tail"] = patches, (M.tiling.shape, len(M.tail.levels))
    # a 1 x 4 mesh over 17 nodes: a rank holds one column of the 9-node
    # level, so the V-cycle goes replicated there with one serial level left
    m14 = pmesh.ProcessMesh.create((1, 4), device=dev)
    A14, f14, _ = pd.assemble_poisson_dist(pd.DistGrid.create(16, 16, m14))
    M = make_pc("mg", A14, Options())
    g = pmesh.gather_field(M(pmesh.shard_field(inp["r14"], m14)), m14)
    res = krylov.cg(A14, f14, M=M, rtol=1e-10, maxiter=100)
    x = pmesh.gather_field(res.x, m14)
    if m.rank == 0:
        out["mg14"], out["cg_mg14_x0"] = g.numpy(), x.numpy()
    out["cg_mg14_its"] = (res.iterations, res.reason_name())
    out["mg14_levels"] = ([lvl.A.grid_shape for lvl in M.levels], M.tiling.cols,
                          [lvl.A.grid_shape for lvl in M.tail.levels])

    K, rhs, _ = pd.assemble_saddle_dist(grid, body_force="trig")
    M = make_pc("fieldsplit", K, Options(KKT_OPTS), ksp_type="minres")
    put_result("minres_mg", krylov.minres(K, rhs, M=M, rtol=1e-8, maxiter=1000))
    out["make_pc"] = [type(make_pc(t, A, Options())).__name__ for t in ("sor", "fieldsplit", "mg")]
    out["jax_loaded"] = sorted(k for k in sys.modules if k == "jax" or k.startswith("saddle_point_petsc_tpu."))
    if m.rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_draws(shapes):
    import jax

    return {s: np.asarray(jax.random.normal(jax.random.PRNGKey(0), s, np.float64)) for s in shapes}


def _jax_references(inputs):
    """The JAX package's results on a (2, 2) mesh, and on (1, 4) for the
    MG that goes replicated above its coarsest level."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from saddle_point_petsc_tpu.parallel import dist as jd
    from saddle_point_petsc_tpu.parallel.mesh import GX, GY, make_mesh
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu.solvers import precond as jpc
    from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
    from saddle_point_petsc_tpu.utils.options import Options as JOptions

    mesh = make_mesh(4, shape=(2, 2))
    grid = jd.DistGrid.create(NEX, NEX, mesh)
    A, f, _ = jd.assemble_poisson_dist(grid)
    r = jax.device_put(jnp.asarray(inputs["r"]), NamedSharding(mesh, P(None, GY, GX)))
    out = {}
    apply = jax.jit(lambda M, v: M(v))  # one program: eager sharded steps take minutes

    def keep(name, res):
        out[f"{name}_its"] = (int(res.iterations), res.reason_name())
        for k, leaf in enumerate(res.x if isinstance(res.x, tuple) else (res.x,)):
            out[f"{name}_x{k}"] = np.asarray(leaf)

    for order in SOR_ORDERS:
        out[f"sor_{order}"] = np.asarray(apply(jpc.sor(A, order=order), r))
    keep("cg_sor", jk.cg(A, f, M=jmake_pc("sor", A), rtol=1e-10, maxiter=500))
    for fs in FS_TYPES:
        M = jmake_pc("fieldsplit", A, JOptions(["-pc_fieldsplit_type", fs]))
        out[f"fs_{fs}"] = np.asarray(apply(M, r))
        solve = jk.cg if fs == "additive" else jk.gmres
        keep(f"fs_{fs}_solve", solve(A, f, M=M, rtol=1e-10, maxiter=500))
    for sm in SMOOTHERS:
        M = jmake_pc("mg", A, JOptions(["-pc_mg_smoother", sm]))
        out[f"mg_{sm}"] = np.asarray(apply(M, r))
        keep(f"cg_mg_{sm}", jk.cg(A, f, M=M, rtol=1e-10, maxiter=100))
    mesh14 = make_mesh(4, shape=(1, 4))
    A14, f14, _ = jd.assemble_poisson_dist(jd.DistGrid.create(16, 16, mesh14))
    M = jmake_pc("mg", A14, JOptions())
    out["mg14"] = np.asarray(apply(M, jax.device_put(jnp.asarray(inputs["r14"]),
                                                     NamedSharding(mesh14, P(None, GY, GX)))))
    keep("cg_mg14", jk.cg(A14, f14, M=M, rtol=1e-10, maxiter=100))
    At, ft, mask = jd.assemble_poisson_dist(grid, body_force="trig")
    K = jd.DistSaddleOperator(At, jax.jit(jd.assemble_constraints_dist, static_argnums=(0,))(grid, mask))
    M = jmake_pc("fieldsplit", K, JOptions(KKT_OPTS), ksp_type="minres")
    keep("minres_mg", jk.minres(K, (ft, jnp.zeros((4,))), M=M, rtol=1e-8, maxiter=1000))
    # an even node count never coarsens: above the dense cap, mg raises
    A66, _, _ = jd.assemble_poisson_dist(jd.DistGrid.create(65, 65, mesh))
    with pytest.raises(ValueError) as e:
        jmake_pc("mg", A66, JOptions())
    out["cap_error"] = str(e.value)
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"r": rng.standard_normal((2, 34, 34)), "r14": rng.standard_normal((2, 17, 20)),
            "draws": _jax_draws([(2, n, n) for n in (33, 17, 9)])}


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    """(world, jref): the 4-rank world's results and the JAX package's,
    computed while the world runs."""
    tmp = tmp_path_factory.mktemp("dist_mg")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    with _spawn([str(Path(__file__)), str(tmp / "in.pkl"), str(tmp / "out.pkl")], WORLD, tmp) as wait:
        jref = _jax_references(inputs)
        outs = wait()
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    with open(tmp / "out.pkl", "rb") as fh:
        return pickle.load(fh), jref


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.max(np.abs(want)))


def _same_solve(world, jref, name, tol):
    assert world[f"{name}_its"] == jref[f"{name}_its"]
    assert jref[f"{name}_its"][1] == "CONVERGED_RTOL"
    k = 0
    while f"{name}_x{k}" in jref:
        _close(world[f"{name}_x{k}"], jref[f"{name}_x{k}"], tol)
        k += 1


@pytest.mark.parametrize("order", SOR_ORDERS)
def test_sor_apply_matches_jax(results, order):
    """One red-black SOR apply on the padded grid: each rank colours its
    patch by the parity of its global origin, a half-step one exchange."""
    world, jref = results
    _close(world[f"sor_{order}"], jref[f"sor_{order}"], 1e-12)


def test_cg_sor_matches_jax(results):
    _same_solve(*results, "cg_sor", 1e-10)


@pytest.mark.parametrize("fs", FS_TYPES)
def test_fieldsplit_matches_jax(results, fs):
    """Additive (CG) and multiplicative (GMRES: block Gauss-Seidel is not
    symmetric) fieldsplit: one apply, and the solve."""
    world, jref = results
    _close(world[f"fs_{fs}"], jref[f"fs_{fs}"], 1e-12)
    _same_solve(world, jref, f"fs_{fs}_solve", 1e-10)


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_mg_pc_dist_matches_jax(results, smoother):
    """mg_pc_dist on the padded 33-node grid over 2 x 2: one apply (padding
    rows z = r) and CG, for each smoother."""
    world, jref = results
    _close(world[f"mg_{smoother}"], jref[f"mg_{smoother}"], 1e-12)
    _same_solve(world, jref, f"cg_mg_{smoother}", 1e-10)


def test_mg_levels_are_ragged_and_the_coarsest_gathered(results):
    """Coarse node J lives with fine node 2J: ranks (pj, pi) hold 17 or 16
    rows and columns on the fine level, 9 or 8 on the next, 5 or 4 on the
    third; the 5 x 5 coarsest level is gathered to every rank, where no
    serial level is left above the dense solve."""
    world, _ = results
    ext = {0: (17, 9, 5), 1: (16, 8, 4)}
    want = [[(ext[pj][k], ext[pi][k]) for k in range(3)] for pj in range(2) for pi in range(2)]
    assert [list(map(tuple, p)) for p in world["mg_patches"]] == want
    assert world["mg_tail"] == ((5, 5), 0)


def test_mg_goes_replicated_above_the_coarsest(results):
    """On a 1 x 4 mesh the 17-node grid is split (5, 5, 5 and 2 columns),
    but its 9-node level would leave a rank one column: that level is
    gathered, and the V-cycle runs its one remaining serial level (9 -> 5)
    on every rank. One apply and CG against the JAX package on (1, 4)."""
    world, jref = results
    assert world["mg14_levels"] == ([(17, 17)], ((0, 3), (3, 5), (5, 8), (8, 9)), [(9, 9)])
    _close(world["mg14"], jref["mg14"], 1e-12)
    _same_solve(world, jref, "cg_mg14", 1e-10)


def test_minres_schur_mg_matches_jax(results):
    """BASELINE config 5's solver on the distributed saddle: MINRES +
    Schur(diag) with the distributed MG (Chebyshev smoother) A-block."""
    _same_solve(*results, "minres_mg", 1e-9)


def test_make_pc_builds_the_distributed_pcs(results):
    world, _ = results
    assert world["make_pc"] == ["RedBlackSORPC", "FieldSplitPC", "DistMGPC"]
    assert world["jax_loaded"] == []


def test_cli_dist_mg_four_ranks_matches_jax(results, tmp_path):
    """`python -m saddle_point_petsc_tpu_torch.cli -dist -mesh 2,2
    -pc_type mg` in a spawned 4-rank gloo world: rank 0 alone prints, and
    its its= line and reason equal the JAX library's CG + mg_pc_dist (SOR
    smoother) on (2, 2)."""
    _, jref = results
    argv = ["-m", "saddle_point_petsc_tpu_torch.cli", "-device", "cpu", "-dist", "-mesh", "2,2", "-da_grid_x",
            str(NEX + 1), "-da_grid_y", str(NEX + 1), "-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-10",
            "-ksp_converged_reason", "-no_vtk"]
    outs = _launch(argv, WORLD, tmp_path)
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    assert all(so == "" for _, so, _ in outs[1:])
    its, reason = jref["cg_mg_sor_its"]
    assert f"its={its}, reason={reason}" in outs[0][1]
    assert f"Linear solve CONVERGED due to {reason} iterations {its}" in outs[0][1]


def test_mg_cap_raises_the_jax_error(results, world_of_one):
    """An even node count never coarsens, so 66 x 66 nodes (8712 dofs) is
    over the dense cap: the JAX package's ValueError, raised before any
    level is built or gathered."""
    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc
    from saddle_point_petsc_tpu_torch.utils.options import Options

    _, jref = results
    A, _, _ = pd.assemble_poisson_dist(pd.DistGrid.create(65, 65, world_of_one))
    with pytest.raises(ValueError) as e:
        make_pc("mg", A, Options())
    assert str(e.value) == jref["cap_error"]
    assert "66x66 nodes (8712 dofs)" in str(e.value)


WORLD_OF_ONE = [("mg", ["-pc_mg_smoother", s]) for s in SMOOTHERS] + [
    ("sor", []), ("fieldsplit", ["-pc_fieldsplit_type", "additive"]),
    ("fieldsplit", ["-pc_fieldsplit_type", "multiplicative"]),
    ("mg", ["-pc_mg_smoother", "sor", "-pc_mg_cycles", "2"])]


@pytest.mark.parametrize("pc,opts", WORLD_OF_ONE, ids=["mg-" + s for s in SMOOTHERS]
                         + ["sor", "fieldsplit-additive", "fieldsplit-multiplicative", "mg-sor-cycles2"])
def test_world_of_one_is_the_serial_pc(world_of_one, pc, opts):
    """In a world of one the distributed PC runs its per-rank code with no
    peer, and gives the serial PC's apply to 1e-14 and its iteration count
    and solution; the serial mg_pc's levels are the distributed ones, and
    each level's `pad`, restriction and prolongation give the bits of the
    serial zero ring and of the public `restrict` and `prolong`."""
    from saddle_point_petsc_tpu_torch.models import poisson
    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.solvers import krylov, multigrid
    from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc
    from saddle_point_petsc_tpu_torch.utils.options import Options

    A, f, _ = pd.assemble_poisson_dist(pd.DistGrid.create(NEX, NEX, world_of_one))
    serial = poisson.assemble_poisson(NEX, NEX, device="cpu")
    Md, Ms = make_pc(pc, A, Options(opts)), make_pc(pc, serial.A, Options(opts))
    r = torch.randn((2, NEX + 1, NEX + 1), dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    zd, zs = Md(r), Ms(r)
    assert torch.max(torch.abs(zd - zs)) <= 1e-14 * torch.max(torch.abs(zs))
    solve = krylov.gmres if "multiplicative" in opts else krylov.cg
    rd, rs = (solve(op, b, M=M, rtol=1e-10, maxiter=500) for op, b, M in ((A, f, Md), (serial.A, serial.f, Ms)))
    assert rd.reason_name() == rs.reason_name() == "CONVERGED_RTOL"
    assert rd.iterations == rs.iterations
    assert torch.max(torch.abs(rd.x - rs.x)) <= 1e-14 * torch.max(torch.abs(rs.x))
    if pc == "mg":
        assert [lvl.A.grid_shape for lvl in Md.levels] == [lvl.A.grid_shape for lvl in Ms.levels]
        assert torch.equal(Md.tail.coarse_inv, Ms.coarse_inv)
        x = r
        for ld, ls in zip(Md.levels, Ms.levels):
            ny, nx = x.shape[-2:]
            xc = multigrid.restrict(x, (ny + 1) // 2, (nx + 1) // 2)
            assert torch.equal(ld.A.pad(x), ls.A.pad(x))
            for lvl in (ld, ls):
                assert torch.equal(lvl.restrict(x), xc)
                assert torch.equal(lvl.prolong(xc), multigrid.prolong(xc, ny, nx))
            x = xc


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
