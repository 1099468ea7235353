"""The port's tracing layer (utils/monitor.py): spans on the profiler's
clock and the counter table, on the CPU.

- With no profiler running `monitor.span` is one shared no-op context and
  a solve records nothing; under torch.profiler the program's spans appear
  as user annotations, nested as the work is (MGSmooth L0 under PCApply
  under KSPSolve; PCChebyEigEst under PCSetUp; FEElementMatrices under
  MatAssembly), in a serial MINRES + Schur(MG) solve and in a world-of-one
  gloo `assemble_saddle_dist` + KSP; a CG + gamg solve names its levels
  as MG does.
- Counters: on a 2 x 2 gloo world (this file run as the worker, one
  process a rank) the halo messages and bytes and the all_reduce calls and
  bytes of the halo exchanges, one distributed matvec and one MINRES
  iteration equal what the exchange pattern implies; in a world of one
  they are zero.
- `-log_view` prints each phase's launches, messages, mean message length
  and all_reduces; `-profile` traces hold the program's spans.
- Iteration counts and answers are bit-equal with and without a profiler.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from saddle_point_petsc_tpu_torch import cli
from saddle_point_petsc_tpu_torch.models import poisson, saddle
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import halo
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.solvers import krylov, multigrid, precond
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.utils import monitor
from saddle_point_petsc_tpu_torch.utils.options import Options

REPO = Path(__file__).resolve().parents[1]
MG_SCHUR = ["-ksp_type", "minres", "-pc_type", "fieldsplit", "-pc_fieldsplit_schur_fact_type", "diag",
            "-fieldsplit_inner_pc_type", "mg", "-pc_mg_smoother", "chebyshev", "-ksp_rtol", "1e-8"]

torch.set_num_threads(1)


def _spans(prof):
    """[(name, names of the spans around it, outer to inner)] of the
    program's spans in a finished profile, in start order."""
    evs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.is_user_annotation()),
                 key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for s, t, name in evs:
        while stack and stack[-1][1] < s:
            stack.pop()
        out.append((name, tuple(x[2] for x in stack)))
        stack.append((s, t, name))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _solve_mg_schur(K, rhs):
    ksp = KSP(Options(MG_SCHUR)).set_operators(K).set_from_options()
    ksp.set_up()
    return ksp.solve(rhs)


@pytest.fixture(scope="module")
def serial_trace():
    prob = saddle.assemble_saddle(16, 16, device="cpu", body_force="trig")
    return _profiled(lambda: _solve_mg_schur(prob.K, prob.rhs))


def test_span_without_profiler_is_one_shared_noop(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    a, b = monitor.span("KSPSolve"), monitor.span("MatMult")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, a:  # reentrant
        pass
    prob = saddle.assemble_saddle(8, 8, device="cpu", body_force="trig")
    res = _solve_mg_schur(prob.K, prob.rhs)
    assert res.converged and made == []


@pytest.mark.parametrize("name,outer", [
    ("KSPSolve", ()),
    ("PCSetUp", ()),
    ("MatMult", ("KSPSolve",)),
    ("KSPConvergedTest", ("KSPSolve",)),
    ("PCApply.Schur", ("KSPSolve", "PCApply")),
    ("MGSmooth L0", ("KSPSolve", "PCApply", "PCApply.Schur", "MGApply")),
    ("MGSmooth L1", ("KSPSolve", "PCApply", "PCApply.Schur", "MGApply")),
    ("MGResid L0", ("KSPSolve", "PCApply", "PCApply.Schur", "MGApply")),
    ("MGRestrict L1", ("KSPSolve", "PCApply", "PCApply.Schur", "MGApply")),
    ("MGInterp L0", ("KSPSolve", "PCApply", "PCApply.Schur", "MGApply")),
    ("MGCoarseSolve", ("KSPSolve", "PCApply", "PCApply.Schur", "MGApply")),
    ("PCChebyEigEst", ("PCSetUp",)),
    ("MGCoarseSetUp", ("PCSetUp",)),
    ("PCSetUp.Schur", ("PCSetUp",)),
])
def test_serial_solve_spans_nest(serial_trace, name, outer):
    """Every occurrence of the span sits under `outer` (in that order, with
    at most others between), and it occurs."""
    res, spans = serial_trace
    assert res.converged
    found = [around for n, around in spans if n == name]
    assert found
    for around in found:
        it = iter(around)
        assert all(o in it for o in outer), (name, around)


def test_serial_solve_span_counts(serial_trace):
    """MINRES applies the operator its + 1 times and the PC its + 2 times;
    one V-cycle per PC apply, each smoothing every level twice."""
    res, spans = serial_trace
    names = [n for n, _ in spans]
    its = res.iterations
    assert names.count("KSPSolve") == names.count("PCSetUp") == 1
    assert names.count("MatMult") == its + 1
    assert names.count("PCApply") == names.count("MGApply") == its + 2
    assert names.count("KSPConvergedTest") == its + 1
    levels = sum(1 for n in set(names) if n.startswith("MGSmooth L"))
    assert levels == 2 and names.count("MGSmooth L0") == 2 * (its + 2)


def test_profiler_leaves_the_bits(serial_trace):
    res, _ = serial_trace
    prob = saddle.assemble_saddle(16, 16, device="cpu", body_force="trig")
    plain = _solve_mg_schur(prob.K, prob.rhs)
    assert plain.iterations == res.iterations and plain.rnorm == res.rnorm
    assert all(torch.equal(a, b) for a, b in zip(plain.x, res.x))


@pytest.mark.parametrize("argv", [
    ["-ksp_type", "cg", "-pc_type", "jacobi"],
    ["-ksp_type", "cg", "-pc_type", "mg", "-pc_mg_smoother", "chebyshev"],
    ["-ksp_type", "gmres", "-pc_type", "sor"],
    ["-ksp_type", "fgmres", "-pc_type", "mg"],
    ["-ksp_type", "bcgs", "-pc_type", "jacobi"],
    ["-ksp_type", "chebyshev", "-pc_type", "jacobi"],
    ["-ksp_type", "richardson", "-pc_type", "jacobi", "-ksp_max_it", "25"],
], ids=["cg", "cg-mg", "gmres", "fgmres-mg", "bcgs", "chebyshev", "richardson"])
def test_krylov_bits_with_and_without_profiler(argv):
    """Each solver's spans leave its iterations and answer bit-equal."""
    prob = poisson.assemble_poisson(16, 16, device="cpu")

    def solve():
        ksp = KSP(Options(argv + ["-ksp_rtol", "1e-8"])).set_operators(prob.A).set_from_options()
        return ksp.set_up().solve(prob.f)

    plain = solve()
    traced, spans = _profiled(solve)
    assert plain.iterations == traced.iterations and torch.equal(plain.x, traced.x)
    names = [n for n, _ in spans]
    assert names.count("KSPSolve") == 1 and "MatMult" in names and "PCApply" in names
    assert "KSPConvergedTest" in names


def test_mg_level_names_continue_through_the_tail():
    """A hierarchy's span names carry its level index, from `level0` on, and
    are made once at set-up."""
    A = poisson.assemble_poisson(32, 32, device="cpu").A
    M = multigrid.mg_pc(A, smoother="jacobi", level0=3)
    assert [lvl.spans.smooth for lvl in M.levels] == [f"MGSmooth L{3 + k}" for k in range(len(M.levels))]
    assert M.levels[0].spans.setup == "MGSetUp L3" and M.levels[1].spans.resid == "MGResid L4"


@pytest.fixture(scope="module")
def gamg_trace():
    prob = poisson.assemble_poisson(32, 32, device="cpu")
    ksp = KSP(Options(["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"])).set_operators(prob.A)
    return _profiled(lambda: ksp.set_from_options().set_up().solve(prob.f))


@pytest.mark.parametrize("name", ["MGSmooth L0", "MGResid L0", "MGRestrict L0", "MGInterp L0"])
def test_gamg_apply_names_its_levels(gamg_trace, name):
    """A gamg apply runs multigrid's one cycle, so its levels carry the
    geometric hierarchy's span names, each under PCApply (as PETSc's
    -log_view shows them for PCGAMG)."""
    res, spans = gamg_trace
    assert res.converged
    found = [around for n, around in spans if n == name]
    assert found and all("PCApply" in around for around in found)


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    dev, created = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    assert created
    yield pmesh.ProcessMesh.create(device=dev)
    dist.destroy_process_group()


def test_world_of_one_assembly_and_solve_spans(world_of_one):
    """The -dist route's assembly and solve in a world of one: the assembly
    spans under MatAssembly, the V-cycle's under MGApply, the gather of
    the coarse end, and no message or all_reduce counted."""
    grid = pdist.DistGrid.create(16, 16, world_of_one)
    monitor.reset_counters()

    def run():
        K, rhs, _ = pdist.assemble_saddle_dist(grid)
        return _solve_mg_schur(K, rhs)

    res, spans = _profiled(run)
    assert res.converged
    under = {}
    for name, around in spans:
        under.setdefault(name, set()).update(around)
    for name in ("FEElementMatrices", "FEElementRHS", "MatSetValues", "FEBoundary", "FEConstraints", "HaloAdd"):
        assert "MatAssembly" in under[name], name
    assert {"KSPSolve", "PCApply", "MGApply"} <= under["MGSmooth L0"]
    # a world of one posts nothing in the matvec; restriction still pads
    assert {"KSPSolve", "MGRestrict L0"} <= under["HaloExchange"] and "MatMult" not in under["HaloExchange"]
    assert "PCSetUp" in under["MGGather"] and "MGApply" in under["MGGather"]
    assert {"PCSetUp", "MGSetUp L0"} <= under["PCChebyEigEst"]
    assert not any(k.startswith(("halo.", "all_reduce.", "all_to_all.")) for k in monitor.counters)
    assert not any(k.startswith("B") for k in monitor.counters)  # the CPU runs the plain versions


def test_log_view_reports_what_each_phase_moved(capsys):
    log = monitor.LogView()
    with log.phase("KSPSolve"):
        monitor.count("B1.launches", 5)
        monitor.count("B1.launches.float64", 5)
        monitor.count("B3.launches", 2)
        monitor.count("halo.messages", 4)
        monitor.count("halo.bytes", 1000)
        monitor.count("all_reduce.calls", 3)
    with log.phase("Empty"):
        pass
    with log.phase("PCSetUp"):
        monitor.count("MGCoarse.device")  # a coarsest level inverted on the card
    log.report()
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split() == ["Phase", "Count", "Time", "(s)", "%T", "Launches", "Mess", "AvgLen", "Reduct"]
    row = next(line.split() for line in lines if line.startswith("KSPSolve"))
    assert row[1] == "1" and row[4:] == ["7", "4", "250", "3"]
    assert next(line.split() for line in lines if line.startswith("Empty"))[4:] == ["0", "0", "0", "0"]
    assert next(line.split() for line in lines if line.startswith("PCSetUp"))[4:] == ["1", "0", "0", "0"]


def test_cli_log_view_and_profile_hold_the_spans(tmp_path, capsys):
    argv = ["-device", "cpu", "-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "17", "-da_grid_y",
            "17", "-ksp_rtol", "1e-8", "-fieldsplit_inner_pc_type", "mg", "-log_view", "-no_vtk", "-profile",
            str(tmp_path)]
    run = cli.run(argv)
    assert run.rc == 0
    out = capsys.readouterr().out
    assert "Launches" in out and "Reduct" in out
    for phase in ("Assembly", "PCSetUp", "KSPSolve"):
        assert any(line.split()[:2] == [phase, "1"] for line in out.splitlines() if line.strip()), phase
    trace = json.loads((tmp_path / "kspsolve.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"KSPSolve", "MatMult", "PCApply", "PCApply.Schur", "MGApply", "MGSmooth L0"} <= names


# ---------------------------------------------------------------------------
# the distributed gamg's streaming set-up in a world of one
# ---------------------------------------------------------------------------

GAMG_STREAM = ["-ksp_type", "cg", "-pc_type", "gamg", "-pc_gamg_setup", "stream"]
GAMG_STEPS = ("GAMGRho", "GAMGAggregate", "GAMGProlong", "GAMGGalerkin", "GAMGLevelBuild")


def _stream_setup(world_of_one, m=64):
    """KSP.set_up of CG + stream gamg on the 5-point Laplacian of an m x m
    interior grid (66 x 66 nodes), a DistAIJ in a world of one."""
    import scipy.sparse as sps

    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    a = (sps.kron(sps.identity(m), t) + sps.kron(t, sps.identity(m))).tocsr()
    A = dist_csr.dist_aij_from_rows(a, m * m, dist_csr.make_mesh_1d(device=world_of_one.device))
    return KSP(Options(GAMG_STREAM)).set_operators(A).set_from_options().set_up()


def test_gamg_stream_setup_spans(world_of_one):
    """Under the profiler each step of each level of the stream set-up is
    one span named with its level, and the coarsest level's gather and
    inverse one `GAMGCoarseSetUp`, all under `PCSetUp`."""
    ksp, spans = _profiled(lambda: _stream_setup(world_of_one))
    levels = len(ksp.M.levels)
    assert levels == 2
    names = [n for n, _ in spans]
    for step in GAMG_STEPS:
        for k in range(levels):
            assert names.count(f"{step} L{k}") == 1, (step, k)
        assert f"{step} L{levels}" not in names
    assert names.count("GAMGCoarseSetUp") == 1
    for name, around in spans:
        if name.startswith("GAMG"):
            assert around[:1] == ("PCSetUp",) and not any(o.startswith("GAMG") for o in around), (name, around)
    # the levels' DistAIJ builds are the set-up's own, not a MatAssembly
    assert "MatAssembly" not in names


def test_gamg_counters_equal_the_hierarchy(world_of_one):
    """`GAMG.levels`, `GAMG.rows` and `GAMG.nnz` count every level's
    operator, the coarsest included (its entries: the Galerkin product of
    the last level's transfers), and a world of one fetches no rows."""
    monitor.reset_counters()
    M = _stream_setup(world_of_one).M
    ops = [lvl.A.to_scipy_rows()[: lvl.A.shape[0]] for lvl in M.levels]
    last = M.levels[-1]
    R, A, P = (x.to_scipy().tocsr() for x in (last.R, last.A, last.P))
    coarse = (R @ (A @ P)).tocsr()
    coarse.eliminate_zeros()
    c = monitor.counters
    assert c["GAMG.levels"] == len(M.levels) + 1
    assert c["GAMG.rows"] == sum(a.shape[0] for a in ops) + coarse.shape[0]
    assert c["GAMG.nnz"] == sum(a.nnz for a in ops) + coarse.nnz
    # the Galerkin triplets went to the device and back; they are all of it
    assert c["triplets.h2d_bytes"] == c["triplets.d2h_bytes"] > 0


def test_gamg_stream_setup_counts_its_dist_aij_builds(world_of_one, monkeypatch):
    """`aij_build.count` counts the operator's own build and then P, R and
    Ac a level; in a world of one each build downloads under 1 KiB (its
    statistics and band offsets) and uploads its CSR's arrays."""
    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    real, moved = dist_csr.dist_aij_from_rows, []

    def build(*args, **kwargs):
        before = [monitor.counters.get(f"aij_build.{k}", 0) for k in ("d2h_bytes", "h2d_bytes")]
        out = real(*args, **kwargs)
        moved.append([monitor.counters[f"aij_build.{k}"] - b for k, b in zip(("d2h_bytes", "h2d_bytes"), before)])
        return out

    monkeypatch.setattr(dist_csr, "dist_aij_from_rows", build)
    monitor.reset_counters()
    M = _stream_setup(world_of_one).M
    c = monitor.counters
    assert c["aij_build.count"] == len(moved) == 1 + 3 * (c["GAMG.levels"] - 1) == 1 + 3 * len(M.levels)
    assert all(0 < down < 1024 and up > 0 for down, up in moved), moved
    assert c["aij_build.d2h_bytes"] == sum(down for down, _ in moved)


def test_gamg_setup_off_the_profiler_records_nothing(world_of_one, monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    ksp = _stream_setup(world_of_one)
    assert ksp.M.levels and made == []


# ---------------------------------------------------------------------------
# the counters on a 2 x 2 gloo world: this file is the worker
# ---------------------------------------------------------------------------


def _worker(out_dir):
    import torch.distributed as dist

    dev, _ = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    m = pmesh.ProcessMesh.create((2, 2), device=dev)
    K, (f, g), _ = pdist.assemble_saddle_dist(pdist.DistGrid.create(16, 16, m))
    M = precond.schur_pc(K.A, K.Bf, fact_type="diag")
    u = torch.ones_like(f)
    moved = {}

    def count(name, fn):
        monitor.reset_counters()
        fn()
        moved[name] = dict(monitor.counters)

    count("halo_exchange", lambda: halo.halo_exchange(u, m))
    count("halo_exchange_1phase", lambda: halo.halo_exchange_1phase(u, m))
    count("halo_add", lambda: halo.halo_add(F.pad(u, (1, 1, 1, 1)), m))
    count("matvec", lambda: K.A(u))
    count("saddle_matvec", lambda: K((u, g)))
    for k in (1, 2):
        count(f"minres{k}", lambda k=k: krylov.minres(K, (f, g), M=M, rtol=1e-30, maxiter=k))
    out = {"pos": [m.pj, m.pi], "shape": list(f.shape), "itemsize": f.element_size(), "moved": moved}
    Path(out_dir, f"rank{m.rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_counts(tmp_path_factory):
    """Each rank's counters after each operation, from one 2 x 2 world."""
    out_dir = tmp_path_factory.mktemp("counts")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for r in range(4):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": "4", "LOCAL_RANK": str(r),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "PYTHONPATH": str(REPO),
                   "OMP_NUM_THREADS": "1"}
            procs.append(subprocess.Popen([sys.executable, __file__, str(out_dir)], cwd=REPO, env=env, text=True,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(4)]


def _implied(rank, op):
    """(messages, bytes, all_reduces, all_reduce bytes) that `op` posts on
    this rank of the 2 x 2 mesh: a send to each neighbour that exists,
    shaped like the face it sends."""
    pj, pi = rank["pos"]
    c, my, mx = rank["shape"]
    w = rank["itemsize"]

    def peers(dirs):
        return [(dj, di) for dj, di in dirs if 0 <= pj + dj < 2 and 0 <= pi + di < 2]

    def face(rows, cols):
        return c * rows * cols * w

    box = peers(halo.DIRECTIONS)
    box_bytes = sum(face(my if dj == 0 else 1, mx if di == 0 else 1) for dj, di in box)
    xs, ys = peers(((0, -1), (0, 1))), peers(((-1, 0), (1, 0)))
    lam = 4 * w  # B u: the four constraint rows
    return {
        # x faces, then y faces of the patch widened by its x ghosts
        "halo_exchange": (len(xs) + len(ys), len(xs) * face(my, 1) + len(ys) * face(1, mx + 2), 0, 0),
        "halo_exchange_1phase": (len(box), box_bytes, 0, 0),
        # y faces of the padded patch, then x faces of the owned rows
        "halo_add": (len(ys) + len(xs), len(ys) * face(1, mx + 2) + len(xs) * face(my, 1), 0, 0),
        "matvec": (len(box), box_bytes, 0, 0),
        "saddle_matvec": (len(box), box_bytes, 1, lam),
        # the operator, <v, A v> and <r, M r>: three sums of which B u is one
        "minres_iteration": (len(box), box_bytes, 3, lam + 2 * w),
    }[op]


@pytest.mark.parametrize("op", ["halo_exchange", "halo_exchange_1phase", "halo_add", "matvec", "saddle_matvec",
                                "minres_iteration"])
def test_counts_on_a_2x2_world(world_counts, op):
    keys = ("halo.messages", "halo.bytes", "all_reduce.calls", "all_reduce.bytes")
    for rank in world_counts:
        if op == "minres_iteration":
            one, two = rank["moved"]["minres1"], rank["moved"]["minres2"]
            got = tuple(two.get(k, 0) - one.get(k, 0) for k in keys)
        else:
            got = tuple(rank["moved"][op].get(k, 0) for k in keys)
        assert got == _implied(rank, op), (rank["pos"], op)
        if op in ("halo_exchange_1phase", "matvec"):
            assert got[0] == 3  # two edges and a corner


def test_counts_in_a_world_of_one_are_zero(world_of_one):
    K, (f, g), _ = pdist.assemble_saddle_dist(pdist.DistGrid.create(16, 16, world_of_one))
    M = precond.schur_pc(K.A, K.Bf, fact_type="diag")
    monitor.reset_counters()
    K((torch.ones_like(f), g))
    halo.halo_add(F.pad(f, (1, 1, 1, 1)), world_of_one)
    res = krylov.minres(K, (f, g), M=M, rtol=1e-30, maxiter=3)
    assert res.iterations == 3 and monitor.counters == {}


if __name__ == "__main__":
    _worker(sys.argv[1])
