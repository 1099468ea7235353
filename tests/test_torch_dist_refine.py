"""Port parity: mixed-precision refinement (solvers/refine.py) on the
distributed operators of saddle_point_petsc_tpu_torch (DistSaddleOperator,
DistStencilOperator), against the JAX package's refinement on a (2, 2)
mesh of fake CPU devices: float32 inner solves, float64 residuals.

One module-scoped gloo world of 4 ranks (2 x 2) runs every distributed
case of the port once, as in tests/test_torch_dist.py: this file, run as
a script, is the worker (no jax); rank 0 returns the gathered results.
The parent builds the JAX references on `make_mesh(4, shape=(2, 2))`
while the world runs:

- the twin of tests/test_refine.py::test_refined_kkt_distributed_parity:
  the 32^2-node trig KKT system, assembled by the JAX package in f64 and
  handed to both packages as the same numpy arrays, refined to rtol 1e-8
  with the default diag-Schur MINRES inner (rtol 1e-4);
- the twin of tests/test_assemble_df.py::test_df_assembly_solves_to_1e8:
  the 25^2-node grid, padded to 26 on 2 x 2, assembled by each package on
  its mesh (the port's f64 `assemble_saddle_dist`, the JAX package's
  `assemble_saddle_dist_df`), inner rtol 1e-3;
- the `minres-mg` and `fgmres-mg` inners of the JAX bench's
  `bench_refined_kkt_dist` (bench.py:489-527) at 33^2 nodes (padded to
  34), inner rtol 1e-3, the Chebyshev smoother's estimate_lmax starting
  from the JAX package's float32 draw of each level's global vector;
- `solve_refined` on a DistStencilOperator Poisson (17^2 nodes, padded to
  18) with `inner_cg` in float32 to rtol 1e-10, beside the JAX package's
  serial refinement of the same system.

Tolerances, those of the JAX test: rtol 1e-8 reached (1e-10 for the
Poisson), cycles equal to the JAX package's, inner iterations within 5
(the JAX residual is a compensated f32 pair, the port's is f64, and gloo
sums the ranks' dots in another order than psum), x within 1e-9 of the
JAX solution. Every true residual is recomputed here in f64 from the
gathered patches with the plain serial matvec, sharing no code with
refine.py; the padding nodes hold exact zeros in x and in that residual.
A world of one, in process, gives the serial refinement's bits.
"""
import dataclasses
import pickle
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from test_torch_dist import _spawn, world_of_one  # noqa: F401  (a fixture)

WORLD = 4
NEX_PARITY = 31  # 32 nodes a side: the 2 x 2 mesh divides them
NEX_PADDED = 24  # 25 nodes, padded to 26
NEX_MG = 32  # 33 nodes, padded to 34: ragged MG levels (17 and 16, 9 and 8)
NEX_POISSON = 16  # 17 nodes, padded to 18
INNERS = ("minres-mg", "fgmres-mg")
STOPPED_ITS = 50  # the inner cap of a refinement whose inner rtol (1e-12) no correction solve reaches


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
    from saddle_point_petsc_tpu_torch.solvers import krylov, precond, refine
    from saddle_point_petsc_tpu_torch.solvers.refine import kkt_f32, refine_inner

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

    def keep(name, K64, rhs, run):
        """Record a refinement: (cycles, its, rnorm, rnorm0), the gathered
        u, lam, and the gathered operator and right-hand side."""
        x, cycles, its, rn, rn0 = run()
        out[f"{name}_run"] = (cycles, its, rn, rn0)
        out[f"{name}_dtypes"] = (x[0].dtype, x[1].dtype)
        for k, t in (("u", x[0]), ("planes", K64.A.planes), ("Bf", K64.Bf), ("f", rhs[0])):
            put(f"{name}_{k}", t)
        out[f"{name}_lam"], out[f"{name}_g"] = x[1].numpy(), rhs[1].numpy()

    # the JAX test's system: the JAX package's serial f64 arrays, sharded
    planes, Bf, f, g = (pmesh.shard_field(a, m) if a.ndim >= 2 else torch.from_numpy(a) for a in inp["kkt32"])
    n = NEX_PARITY + 1
    K64 = pd.DistSaddleOperator(pd.DistStencilOperator(planes, m, active_shape=(n, n)), Bf)
    K32 = kkt_f32(K64)
    M = precond.schur_pc(K32.A, K32.Bf, fact_type="diag")
    keep("parity", K64, (f, g), refine.solve_refined_kkt_fused(
        K32, (f, g), rtol=1e-8, planes_df=planes, Bf_df=Bf, M=M, inner_rtol=1e-4, inner_maxiter=1500))
    # every inner solve stopped at STOPPED_ITS iterations (DIVERGED_ITS)
    keep("stopped", K64, (f, g), refine.solve_refined_kkt_fused(
        K32, (f, g), rtol=1e-8, planes_df=planes, Bf_df=Bf, M=M, inner_rtol=1e-12, inner_maxiter=STOPPED_ITS))
    # the replicated g counts once in the norm of (f, g)
    with krylov.distributed(m, K64.dist_leaves):
        out["tnorm"] = krylov.tnorm((f, torch.from_numpy(inp["g_test"]))).item()
    # global arrays where this rank's patches belong
    glob = dict(zip(("planes_df", "Bf_df"), (torch.from_numpy(a) for a in inp["kkt32"][:2])))
    for name, arr in glob.items():
        kw = {"planes_df": planes, "Bf_df": Bf, name: arr}
        try:
            refine.solve_refined_kkt_fused(K32, (f, g), M=M, **kw)()
        except Exception as e:  # noqa: BLE001  (the test names the type it wants)
            out[f"shape_error_{name}"] = (type(e).__name__, str(e))

    # the padded 25^2 grid, assembled on the mesh
    K64, rhs, _ = pd.assemble_saddle_dist(pd.DistGrid.create(NEX_PADDED, NEX_PADDED, m), body_force="trig")
    K32 = kkt_f32(K64)
    keep("padded", K64, rhs, refine.solve_refined_kkt_fused(
        K32, rhs, rtol=1e-8, planes_df=K64.A.planes, Bf_df=K64.Bf, M=precond.schur_pc(K32.A, K32.Bf, fact_type="diag"),
        inner_rtol=1e-3, inner_maxiter=2000))

    # the JAX bench's MG inners at 33^2
    K64, rhs, _ = pd.assemble_saddle_dist(pd.DistGrid.create(NEX_MG, NEX_MG, m), body_force="trig")
    K32 = kkt_f32(K64)
    for kind in INNERS:
        keep(kind, K64, rhs, refine.solve_refined_kkt_fused(
            K32, rhs, rtol=1e-8, planes_df=K64.A.planes, Bf_df=K64.Bf, inner_rtol=1e-3, inner_maxiter=2000,
            **refine_inner(K32, kind)))

    # solve_refined on the DistStencilOperator Poisson: the residual through
    # the f64 operator's own matvec (halo exchanges), f32 CG inside
    A64, b, _ = pd.assemble_poisson_dist(pd.DistGrid.create(NEX_POISSON, NEX_POISSON, m), body_force="trig")
    A32 = dataclasses.replace(A64, planes=A64.planes.float())
    res = refine.solve_refined(A64, b, refine.inner_cg(A32, rtol=1e-4, maxiter=300), rtol=1e-10, max_cycles=8)
    out["poisson_run"] = (res.cycles, res.inner_iterations, res.rnorm, res.rnorm0, len(res.history))
    for k, t in (("x", res.x), ("planes", A64.planes), ("f", b)):
        put(f"poisson_{k}", t)

    out["jax_loaded"] = sorted(k for k in sys.modules if k == "jax" or k.startswith("saddle_point_petsc_tpu."))
    if m.rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_references(inputs):
    """The JAX package's refinements on a (2, 2) mesh: (cycles, its, rnorm,
    rnorm0) and x in f64 for each case, and the serial Poisson's."""
    import jax

    from saddle_point_petsc_tpu.models import poisson as jpoisson
    from saddle_point_petsc_tpu.models.assemble_df import assemble_saddle_dist_df
    from saddle_point_petsc_tpu.ops.doublefloat import DF, df_from_f64, df_to_f64
    from saddle_point_petsc_tpu.ops.stencil import StencilOperator as JStencil
    from saddle_point_petsc_tpu.parallel import dist as jd
    from saddle_point_petsc_tpu.parallel.mesh import make_mesh, shard_field
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu.solvers import precond as jpc
    from saddle_point_petsc_tpu.solvers import refine as jrefine
    from saddle_point_petsc_tpu.solvers.multigrid import mg_pc_dist

    mesh = make_mesh(4, shape=(2, 2))
    out = {}

    def keep(name, run):
        x, cycles, its, rn, rn0 = jax.device_get(run())
        out[f"{name}_run"] = (int(cycles), int(its), float(rn), float(rn0))
        out[f"{name}_u"], out[f"{name}_lam"] = df_to_f64(x[0]), df_to_f64(x[1])

    # tests/test_refine.py::test_refined_kkt_distributed_parity on (2, 2)
    planes, Bf, f, g = inputs["kkt32"]
    sh = lambda df: DF(shard_field(df.hi, mesh), shard_field(df.lo, mesh))  # noqa: E731
    planes_dd, Bf_dd, f_dd = (sh(df_from_f64(a)) for a in (planes, Bf, f))
    n = NEX_PARITY + 1
    Ad = jd.DistStencilOperator(planes_dd.hi, mesh, active_shape=(n, n))
    Kd = jd.DistSaddleOperator(Ad, Bf_dd.hi)
    Md = jpc.schur_pc(Ad, Bf_dd.hi, fact_type="diag")
    for name, inner_rtol, maxiter in (("parity", 1e-4, 1500), ("stopped", 1e-12, STOPPED_ITS)):
        keep(name, jrefine.solve_refined_kkt_fused(
            Kd, (f_dd, df_from_f64(g)), rtol=1e-8, planes_df=planes_dd, Bf_df=Bf_dd, M=Md, inner_rtol=inner_rtol,
            inner_maxiter=maxiter))

    def assembled(nex):
        planes_dd, Bf_dd, f_dd, g_df, _ = assemble_saddle_dist_df(jd.DistGrid.create(nex, nex, mesh), "trig")
        Ad = jd.DistStencilOperator(planes_dd.hi, mesh, active_shape=(nex + 1, nex + 1))
        return Ad, jd.DistSaddleOperator(Ad, Bf_dd.hi), dict(planes_df=planes_dd, Bf_df=Bf_dd), (f_dd, g_df)

    # tests/test_assemble_df.py::test_df_assembly_solves_to_1e8 on (2, 2)
    Ad, Kd, dfs, b = assembled(NEX_PADDED)
    keep("padded", jrefine.solve_refined_kkt_fused(
        Kd, b, rtol=1e-8, M=jpc.schur_pc(Ad, Kd.Bf, fact_type="diag"), inner_rtol=1e-3, inner_maxiter=2000, **dfs))

    # bench.py:489-527, the MG inners
    Ad, Kd, dfs, b = assembled(NEX_MG)
    for kind in INNERS:
        if kind == "fgmres-mg":
            Mmg = jpc.schur_pc(Ad, Kd.Bf, inner_solve=mg_pc_dist(Ad, smoother="chebyshev"), fact_type="full")

            def inner(ru, rlam, ops):
                res = jk.fgmres(ops[0], (ru, rlam), M=ops[1], rtol=1e-3, maxiter=60, restart=30)
                return res.x, res.iterations

            kw = dict(inner=inner, inner_operands=(Kd, Mmg))
        else:
            kw = dict(M=jpc.schur_pc(Ad, Kd.Bf, mg_pc_dist(Ad, smoother="chebyshev"), fact_type="diag"))
        keep(kind, jrefine.solve_refined_kkt_fused(Kd, b, rtol=1e-8, inner_rtol=1e-3, inner_maxiter=2000, **kw,
                                                   **dfs))

    # tests/test_refine.py::test_refined_solve_reaches_1em10_with_f32_inner
    # on the trig Poisson: the serial JAX refinement
    jp = jpoisson.assemble_poisson(NEX_POISSON, NEX_POISSON, body_force="trig")
    p64 = np.asarray(jp.A.planes)

    class DFOp:
        planes = jax.numpy.asarray(p64.astype(np.float32))
        planes_df = df_from_f64(p64)

    res = jrefine.solve_refined(DFOp(), df_from_f64(np.asarray(jp.f)),
                                jrefine.inner_cg(JStencil(DFOp.planes), rtol=1e-4, maxiter=300),
                                rtol=1e-10, max_cycles=8)
    out["poisson_run"] = (res.cycles, res.inner_iterations, float(res.rnorm), float(res.rnorm0))
    out["poisson_x"] = df_to_f64(res.x)
    return out


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    from saddle_point_petsc_tpu.models import saddle as jsaddle

    jp = jsaddle.assemble_saddle(NEX_PARITY, NEX_PARITY, dtype=jnp.float64, body_force="trig")
    return {
        "kkt32": tuple(np.asarray(a) for a in (jp.A.planes, jp.Bf, jp.f, jp.g)),
        "g_test": np.random.default_rng(0).standard_normal(4),
        # estimate_lmax's start on each MG level's global grid, in float32
        "draws": {(2, s, s): np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, s, s), jnp.float32))
                  for s in (33, 17, 9)},
    }


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    """(world, jref): the 4-rank world's results and the JAX package's,
    computed while the world runs."""
    tmp = tmp_path_factory.mktemp("dist_refine")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    with _spawn([str(Path(__file__)), str(tmp / "in.pkl"), str(tmp / "out.pkl")], WORLD, tmp) as wait:
        jref = _jax_references(inputs)
        outs = wait()
    for rc, so, se in outs:
        assert rc == 0, se[-3000:]
    with open(tmp / "out.pkl", "rb") as fh:
        return pickle.load(fh), jref


def _true_rel(world, name, n):
    """|b - K x| / |b| in f64 on the active n x n grid, from the gathered
    planes, rows, right-hand side and solution, through the plain serial
    matvec; and the residual's u part on the whole padded grid."""
    from saddle_point_petsc_tpu_torch.ops.stencil import planes_matvec_field
    from saddle_point_petsc_tpu_torch.solvers.operators import constraint_apply, constraint_apply_t

    planes, Bf, f, u = (torch.from_numpy(world[f"{name}_{k}"]) for k in ("planes", "Bf", "f", "u"))
    lam, g = torch.from_numpy(world[f"{name}_lam"]), torch.from_numpy(world[f"{name}_g"])
    ru = f - planes_matvec_field(planes, u) - constraint_apply_t(Bf, lam)
    rlam = g - constraint_apply(Bf, u)
    rn = torch.sqrt(torch.sum(ru[:, :n, :n] ** 2) + torch.sum(rlam ** 2))
    return (rn / torch.sqrt(torch.sum(f[:, :n, :n] ** 2) + torch.sum(g ** 2))).item(), ru


def _same_refinement(world, jref, name, n, x_tol=None):
    """Both reach rtol 1e-8, with equal cycles and inner iterations within
    5; the port's true residual, recomputed here, is at most 1e-8."""
    cycles, its, rn, rn0 = world[f"{name}_run"]
    jcycles, jits, jrn, jrn0 = jref[f"{name}_run"]
    assert world[f"{name}_dtypes"] == (torch.float64, torch.float64)
    assert rn <= 1e-8 * rn0 and jrn <= 1e-8 * jrn0, (rn / rn0, jrn / jrn0)
    assert cycles == jcycles >= 2, (cycles, jcycles)
    assert abs(its - jits) <= 5, (its, jits)
    true_rel, ru = _true_rel(world, name, n)
    assert true_rel <= 1e-8, true_rel
    if x_tol is not None:
        np.testing.assert_allclose(world[f"{name}_u"], jref[f"{name}_u"], rtol=0, atol=x_tol)
        np.testing.assert_allclose(world[f"{name}_lam"], jref[f"{name}_lam"], rtol=0, atol=x_tol)
    return ru


def test_refined_kkt_distributed_parity(results):
    """The JAX test's refinement on 2 x 2 ranks: rtol 1e-8 reached through
    the distributed f64 residual (halo edge terms, B u summed over the
    ranks), the JAX package's cycles, inner iterations within 5, x within
    1e-9; the loop's final norm is the true residual's."""
    world, jref = results
    _same_refinement(world, jref, "parity", NEX_PARITY + 1, x_tol=1e-9)
    cycles, its, rn, rn0 = world["parity_run"]
    true_rel, _ = _true_rel(world, "parity", NEX_PARITY + 1)
    np.testing.assert_allclose(rn / rn0, true_rel, rtol=1e-6)


def test_stopped_inner_solves_still_correct(results):
    """Every inner MINRES stopped at its cap (inner rtol 1e-12,
    DIVERGED_ITS) still returns its correction, which counts as a cycle,
    as in the JAX loop: rtol 1e-8 in the JAX package's cycle count, the
    cap's iterations a cycle."""
    world, jref = results
    _same_refinement(world, jref, "stopped", NEX_PARITY + 1)
    cycles, its, *_ = world["stopped_run"]
    assert its == jref["stopped_run"][1] == STOPPED_ITS * cycles


@pytest.mark.parametrize("name,nex", [("padded", NEX_PADDED), ("minres-mg", NEX_MG), ("fgmres-mg", NEX_MG)])
def test_padded_refinement_matches_jax(results, name, nex):
    """Grids padded to divide the mesh: the 25^2 twin of the JAX
    df-assembly test (diag-Schur MINRES, inner rtol 1e-3) and the bench's
    MG inners at 33^2 (ragged MG levels); the padding nodes keep x = 0 and
    add exact zeros to the residual."""
    world, jref = results
    n = nex + 1
    ru = _same_refinement(world, jref, name, n)
    u = world[f"{name}_u"]
    assert u.shape[-1] == n + 1
    assert not np.any(u[:, n:, :]) and not np.any(u[:, :, n:])
    assert not torch.any(ru[:, n:, :]) and not torch.any(ru[:, :, n:])


def test_solve_refined_on_dist_stencil(results):
    """solve_refined on a DistStencilOperator: the default residual is the
    f64 operator's own distributed matvec, f32 CG (rtol 1e-4) inside, rtol
    1e-10 reached in the JAX package's serial cycle count; the true
    residual, recomputed here, at most 1e-10."""
    from saddle_point_petsc_tpu_torch.ops.stencil import planes_matvec_field

    world, jref = results
    cycles, its, rn, rn0, n_hist = world["poisson_run"]
    assert rn <= 1e-10 * rn0 and n_hist == cycles + 1
    assert cycles == jref["poisson_run"][0] >= 2
    planes, f, x = (torch.from_numpy(world[f"poisson_{k}"]) for k in ("planes", "f", "x"))
    n = NEX_POISSON + 1
    r = f - planes_matvec_field(planes, x)
    assert (torch.linalg.norm(r[:, :n, :n]) / torch.linalg.norm(f)).item() <= 1e-10
    assert not torch.any(x[:, n:, :]) and not torch.any(x[:, :, n:])
    np.testing.assert_allclose(world["poisson_x"][:, :n, :n], jref["poisson_x"], rtol=0,
                               atol=1e-8 * np.max(np.abs(jref["poisson_x"])))


def test_tnorm_counts_the_replicated_leaf_once(results, inputs):
    """Under the KKT operator's distribution the residual norm sums the u
    patches over the ranks and adds the replicated g once."""
    world, _ = results
    f, g = inputs["kkt32"][2], inputs["g_test"]
    np.testing.assert_allclose(world["tnorm"], np.sqrt(np.sum(f ** 2) + np.sum(g ** 2)), rtol=1e-14)


@pytest.mark.parametrize("name", ["planes_df", "Bf_df"])
def test_global_arrays_for_a_patch_raise(results, name):
    """planes_df or Bf_df shaped as the global arrays where this rank's
    patch belongs: ValueError, never a silent slice."""
    world, _ = results
    kind, msg = world[f"shape_error_{name}"]
    assert kind == "ValueError", (kind, msg)
    assert msg.startswith(f"{name} has shape (") and "this rank's patch" in msg
    assert "32, 32)" in msg and "16, 16)" in msg
    assert world["jax_loaded"] == []


@pytest.mark.parametrize("case", ["kkt", "poisson"])
def test_world_of_one_is_the_serial_refinement(world_of_one, case):
    """In a world of one the distributed refinement runs the serial
    arithmetic: the same cycles, inner iterations, norms and solution bits
    as the refinement of the serial operator."""
    from saddle_point_petsc_tpu_torch.models import poisson, saddle
    from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.solvers import refine
    from saddle_point_petsc_tpu_torch.solvers.refine import kkt_f32

    torch.set_num_threads(1)
    grid = pd.DistGrid.create(NEX_POISSON, NEX_POISSON, world_of_one)
    if case == "kkt":
        Kd, rhs_d, _ = pd.assemble_saddle_dist(grid, body_force="trig")
        sp = saddle.assemble_saddle(NEX_POISSON, NEX_POISSON, device="cpu", body_force="trig")
        runs = [refine.solve_refined_kkt_fused(kkt_f32(K), rhs, planes_df=K.A.planes, Bf_df=K.Bf)()
                for K, rhs in ((Kd, rhs_d), (sp.K, sp.rhs))]
        (xd, *rd), (xs, *rs) = runs
        assert rd == rs and rd[0] >= 2
        assert all(torch.equal(a, b) for a, b in zip(xd, xs))
    else:
        Ad, bd, _ = pd.assemble_poisson_dist(grid, body_force="trig")
        sp = poisson.assemble_poisson(NEX_POISSON, NEX_POISSON, device="cpu", body_force="trig")
        rd, rs = (refine.solve_refined(A, b, refine.inner_cg(A32, rtol=1e-4, maxiter=300), rtol=1e-10)
                  for A, A32, b in ((Ad, dataclasses.replace(Ad, planes=Ad.planes.float()), bd),
                                    (sp.A, StencilOperator(sp.A.planes.float()), sp.f)))
        assert (rd.cycles, rd.inner_iterations, rd.history) == (rs.cycles, rs.inner_iterations, rs.history)
        assert rd.cycles >= 2 and torch.equal(rd.x, rs.x)


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
