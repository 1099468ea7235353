"""Measure the distributed paths on CUDA cards.

    python -m saddle_point_petsc_tpu_torch.tools.dist_probe overhead
    python -m saddle_point_petsc_tpu_torch.tools.dist_probe mesh [--ranks 4]
    python -m saddle_point_petsc_tpu_torch.tools.dist_probe cli [--repeats 3]
    python -m saddle_point_petsc_tpu_torch.tools.dist_probe aij [--ranks 4]
    python -m saddle_point_petsc_tpu_torch.tools.dist_probe gamg [--ranks 4]
    python -m saddle_point_petsc_tpu_torch.tools.dist_probe mg [--ranks 4]
    python -m saddle_point_petsc_tpu_torch.tools.dist_probe refine [--ranks 4]

`overhead` (one card, a world of one on NCCL): the host time of one
all_reduce of a 0-d tensor, of a halo exchange with no neighbours, and of
a MINRES iteration of BASELINE config 4's solver at 704^2 f32 on the
distributed route and on the serial route with the PC a 1 x 1 mesh
reduces to, each followed by a torch.profiler table of 50 iterations
(host time per operator, device time per kernel).

`cli` (one card, a world of one on NCCL): BASELINE config 4 at 704^2 f32
through the CLI, the -dist route and the serial route with the PC a 1 x 1
mesh reduces to, alternating in one process (dist first), each run's
PCSetUp and KSPSolve seconds and ms per iteration from -log_view. (A world
of one calls no all_reduce: `ProcessMesh.all_reduce` is the identity
there.)

`mesh` (as many cards as ranks): the CLI under `python -m
torch.distributed.run --standalone --nproc_per_node N`, one rank per
card. First the 65^2 f64 saddle route with -dist on a 2 x (N/2) mesh
over NCCL against the same command over gloo on the CPU (equal its= line,
VTK values to 1e-8 of max|u|), then config 4 at 704^2 f32 on N ranks and
on one rank: iterations, KSPSolve seconds and ms per iteration from
-log_view.

`aij` (as many cards as ranks): the row-partitioned DistAIJ route
(-mat_type aij -dist, parallel/dist_csr.py) under `python -m
torch.distributed.run --standalone --nproc_per_node N`. First CG +
bjacobi (per-rank ILU(0)) at 65^2 f64 to rtol 1e-8 over NCCL against the
same command over gloo on the CPU (equal its= line, VTK values within 1e-9
of max|u|), then the 704^2 f32 route (BASELINE config 4's grid, 991,232
rows) to rtol 1e-5 with CG + Jacobi and CG + bjacobi on N ranks and on one
(`aij-rank`, one process per rank): iterations, ms per iteration, each
rank's ghost_count, and the host microseconds of one ghost exchange
(gather, all_to_all, wait) and of one matvec.

`gamg` (as many cards as ranks): the distributed gamg (-mat_type aij
-dist -pc_type gamg). First CG + gamg with the streaming setup at 65^2
f64 over NCCL against gloo on the CPU (counts within 1), then
(`gamg-rank`, one process per rank) the 704^2 Q1 operator in f64
(991,232 rows) on N ranks and on one: PCSetUp seconds of the global and
the streaming setup, run global, stream, stream, global; CG to rtol 1e-8
iterations and ms per iteration; rank 0's host profile of a streaming
setup.

`mg` (as many cards as ranks): the distributed geometric multigrid
(-pc_type mg -dist, `multigrid.mg_pc_dist`). First CG + MG at 65^2 f64 on
a 2 x (N/2) mesh over NCCL against the same command over gloo on the CPU
(equal its= lines), then (`mg-rank`, one process per rank) the 1025^2
Poisson in f64 on N ranks and on one: each rank's patch on every split
level, PCSetUp seconds, CG to rtol 1e-8 iterations and ms per iteration,
and the milliseconds of one V-cycle (20 in a row between barriers).

`refine` (as many cards as ranks): the JAX bench's distributed
mixed-precision refinement (`bench_refined_kkt_dist`, bench.py:407-583):
the KKT system assembled in f64 on a 2 x (N/2) mesh, its f32 copy for the
inner solves and their PC, and `refine.solve_refined_kkt_fused` to rtol
1e-8 with an inner rtol of 1e-3 (f64 residuals through the distributed
f64 operator), with the inner solves of `solvers/refine.py` (`kkt_f32`,
`refine_inner`) that the port's bench runs. First the
`minres-mg` inner at 65^2 over NCCL against the same over gloo on the CPU
(equal cycles and inner iterations), then (`refine-rank`, one process per
rank) at 1025^2 on N ranks and on one: cycles, inner iterations, Assembly,
PCSetUp and solve seconds, and the f64 true relative residual, computed
on rank 0 from the gathered patches with the plain serial matvec. Four
ranks must reach 1e-8 with cycles within 1 of one rank's.

Every time is on the host clock around synchronized device work; the
card's name and power limit are printed with them.
"""
from __future__ import annotations

import argparse
import datetime
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.utils.device import card_line

# BASELINE config 4's A-block PC, and the one a 1 x 1 mesh reduces to
CONFIG4_PC = ["-fieldsplit_inner_pc_type", "bjacobi", "-sub_pc_type", "chebyshev", "-pc_bjacobi_local_its", "4"]
SERIAL4_PC = ["-fieldsplit_inner_pc_type", "chebyshev", "-pc_chebyshev_esteig", "-pc_chebyshev_its", "4"]
CONFIG4_SYSTEM = ["-problem_type", "saddle", "-body_force", "trig", "-dtype", "f32", "-ksp_rtol", "1e-5"]
CONFIG4 = CONFIG4_SYSTEM + CONFIG4_PC


def _card():
    return card_line(torch.device("cuda", 0))


def _host_us(fn, n=500):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def overhead(side=704):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from saddle_point_petsc_tpu_torch.models import saddle
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist
    from saddle_point_petsc_tpu_torch.parallel import halo
    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
    from saddle_point_petsc_tpu_torch.solvers import krylov
    from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc
    from saddle_point_petsc_tpu_torch.utils.options import Options

    card = _card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                                world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = pmesh.ProcessMesh.create(device=dev)
            t = torch.ones((), device=dev)
            print(f"all_reduce of a 0-d tensor: {_host_us(lambda: dist.all_reduce(t)):.1f} us a call; with "
                  f".item() after it {_host_us(lambda: (dist.all_reduce(t), t.item())):.1f} us; .item() alone "
                  f"{_host_us(lambda: t.item()):.1f} us ({card})")
            x = torch.randn((2, side, side), device=dev)
            print(f"halo_exchange_1phase_start + wait, no neighbours: "
                  f"{_host_us(lambda: halo.halo_exchange_1phase_start(x, mesh).wait()):.1f} us a call")
            f32 = torch.float32
            K, rhs, _ = pdist.assemble_saddle_dist(pdist.DistGrid.create(side - 1, side - 1, mesh), dtype=f32,
                                                   body_force="trig")
            sp = saddle.assemble_saddle(side - 1, side - 1, dtype=f32, device=dev, body_force="trig")
            Md = make_pc("fieldsplit", K, Options(CONFIG4_PC), ksp_type="minres")
            Ms = make_pc("fieldsplit", sp.K, Options(SERIAL4_PC), ksp_type="minres")
            for label, (A, b, M) in (("distributed", (K, rhs, Md)), ("serial", (sp.K, sp.rhs, Ms))):
                krylov.minres(A, b, M=M, rtol=1e-30, maxiter=20)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                krylov.minres(A, b, M=M, rtol=1e-30, maxiter=200)
                torch.cuda.synchronize()
                print(f"{label}: {(time.perf_counter() - t0) / 200 * 1e3:.3f} ms a MINRES iteration "
                      f"(200 iterations at {side}^2 f32) ({card})")
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    krylov.minres(A, b, M=M, rtol=1e-30, maxiter=50)
                    torch.cuda.synchronize()
                print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=20))
        finally:
            dist.destroy_process_group()


def cli_runs(repeats, side=704):
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch import cli

    card = _card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    common = ["-device", "cuda", "-da_grid_x", str(side), "-da_grid_y", str(side), "-no_vtk"] + CONFIG4_SYSTEM
    argvs = {"dist": common + ["-dist"] + CONFIG4_PC, "serial": common + SERIAL4_PC}
    print(f"config 4 at {side}^2 f32 through the CLI, alternating, in one process ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                                world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=120))
        try:
            for k in range(repeats):
                for label in argvs:
                    run = cli.run(argvs[label])
                    its = run.result.iterations
                    setup, solve = (run.log.phases[p].total_s for p in ("PCSetUp", "KSPSolve"))
                    print(f"  run {k + 1} {label}: {its} its, {run.result.reason_name()}, PCSetUp {setup:.4f} s, "
                          f"KSPSolve {solve:.4f} s, {solve / its * 1e3:.4f} ms/it", flush=True)
        finally:
            dist.destroy_process_group()


def _torchrun(n, argv, cwd, env=None, module="saddle_point_petsc_tpu_torch.cli"):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
           "-m", module] + argv
    print("$ " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=cwd, env={**os.environ, **(env or {})}, capture_output=True, text=True,
                       timeout=600)
    print(p.stdout.strip())
    if p.returncode != 0:
        print(p.stderr[-4000:])
        raise SystemExit(f"rc {p.returncode}")
    print(f"  ({time.perf_counter() - t0:.1f} s with the launch)", flush=True)
    return p.stdout


def _vtk_values(path):
    lines = open(path).read().split("\n")
    head = [i for i, ln in enumerate(lines) if ln.startswith("POINT_DATA")][0]
    vals = np.array([float(v) for ln in lines[head:] if ln[:1] not in "PVSL" for v in ln.split()])
    return lines[:head], vals


def mesh_runs(ranks):
    card = _card()
    shape = f"2,{ranks // 2}" if ranks > 1 else "1,1"
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {"PYTHONPATH": pkg + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    its = re.compile(r"its=(\d+), reason=(\w+)")
    with tempfile.TemporaryDirectory() as tmp:
        small = ["-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "65", "-da_grid_y", "65",
                 "-dtype", "f64", "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-dist", "-mesh", shape]
        out = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{device}.vtk")
            out[device] = (its.findall(_torchrun(ranks, ["-device", device, "-vtk", path] + small, tmp, env)),
                           _vtk_values(path))
        (its_g, (geo_g, v_g)), (its_c, (geo_c, v_c)) = out["cuda"], out["cpu"]
        dv = float(np.max(np.abs(v_g - v_c)) / np.max(np.abs(v_c)))
        print(f"65^2 f64 on a {shape} mesh: NCCL {its_g}, gloo {its_c}, VTK geometry equal {geo_g == geo_c}, "
              f"max|u_nccl - u_gloo| / max|u| = {dv:.3e}")
        # the ranks' sums reduce in another order on NCCL than on gloo: counts within 1
        if abs(int(its_g[0][0]) - int(its_c[0][0])) > 1 or geo_g != geo_c or not dv <= 1e-8:
            raise SystemExit("NCCL and gloo disagree")
        big = ["-device", "cuda", "-da_grid_x", "704", "-da_grid_y", "704", "-ksp_converged_reason", "-log_view",
               "-no_vtk", "-dist"]
        solve = re.compile(r"^KSPSolve\s+\d+\s+(\S+)", re.M)
        for n, mesh in ((ranks, shape), (1, "1,1")):
            text = _torchrun(n, big + ["-mesh", mesh] + CONFIG4, tmp, env)
            (k, reason), t = its.findall(text)[0], float(solve.findall(text)[0])
            print(f"704^2 f32 config 4 on {n} rank(s), mesh {mesh}: {k} its, {reason}, KSPSolve {t:.4f} s, "
                  f"{t / int(k) * 1e3:.4f} ms/it ({card}, each rank its own card)")


AIJ_SMALL = ["-mat_type", "aij", "-da_grid_x", "65", "-da_grid_y", "65", "-dtype", "f64", "-ksp_type", "cg",
             "-pc_type", "bjacobi", "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-dist"]


def aij_rank(side=704):
    """One rank of the 704^2 f32 -mat_type aij -dist route, under torchrun:
    the CLI with CG + Jacobi and CG + bjacobi, then one ghost exchange and
    one matvec timed on the last run's operator; rank 0 prints every rank's
    numbers."""
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch import cli
    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh

    dev, created = pmesh.init_from_env(torch.device("cuda"))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        argv = ["-device", "cuda", "-mat_type", "aij", "-dist", "-da_grid_x", str(side), "-da_grid_y", str(side),
                "-dtype", "f32", "-ksp_type", "cg", "-ksp_rtol", "1e-5", "-log_view", "-no_vtk"]
        lines = []
        for pc in ("jacobi", "bjacobi"):
            run = cli.run(argv + ["-pc_type", pc])
            its, res = run.result.iterations, run.result
            setup, solve = (run.log.phases[p].total_s for p in ("PCSetUp", "KSPSolve"))
            lines.append(f"{side}^2 f32 CG + {pc} on {world} rank(s): {its} its, {res.reason_name()}, PCSetUp "
                         f"{setup:.3f} s, KSPSolve {solve:.4f} s, {solve / its * 1e3:.4f} ms/it")
        A = run.problem.A
        x = torch.randn((A.n_loc,), device=dev)
        t_x = _host_us(lambda: A._exchange_start(x).wait(), n=200) if A.has_ghosts else None
        t_mv = _host_us(lambda: A.matvec(x), n=200)
        mine = (A.ghost_count, t_x, t_mv)
        everyone = [mine]
        if world > 1:
            everyone = [None] * world
            dist.all_gather_object(everyone, mine)
        if rank == 0:
            card = _card()
            for ln in lines:
                print(f"{ln} ({card}, each rank its own card)")
            for r, (g, tx, tm) in enumerate(everyone):
                ex = "no exchange (no rank has an off-diag entry)" if tx is None else f"{tx:.1f} us a ghost exchange"
                print(f"  rank {r}: ghost_count {g}, {ex}, {tm:.1f} us a matvec (host clock, 200 in a row)")
    finally:
        if created:
            dist.destroy_process_group()


def aij_runs(ranks):
    card = _card()
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {"PYTHONPATH": pkg + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    its = re.compile(r"its=(\d+), reason=(\w+)")
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{device}.vtk")
            out[device] = (its.findall(_torchrun(ranks, ["-device", device, "-vtk", path] + AIJ_SMALL, tmp, env)),
                           _vtk_values(path))
        (its_g, (geo_g, v_g)), (its_c, (geo_c, v_c)) = out["cuda"], out["cpu"]
        dv = float(np.max(np.abs(v_g - v_c)) / np.max(np.abs(v_c)))
        print(f"65^2 f64 -mat_type aij -dist CG + bjacobi on {ranks} ranks: NCCL {its_g}, gloo {its_c}, VTK geometry "
              f"equal {geo_g == geo_c}, max|u_nccl - u_gloo| / max|u| = {dv:.3e} ({card})")
        # the ranks' sums reduce in another order on NCCL than on gloo: counts within 1
        if abs(int(its_g[0][0]) - int(its_c[0][0])) > 1 or geo_g != geo_c or not dv <= 1e-9:
            raise SystemExit("NCCL and gloo disagree")
        for n in (ranks, 1):
            _torchrun(n, ["aij-rank"], tmp, env, module="saddle_point_petsc_tpu_torch.tools.dist_probe")


GAMG_SMALL = ["-mat_type", "aij", "-da_grid_x", "65", "-da_grid_y", "65", "-dtype", "f64", "-ksp_type", "cg",
              "-pc_type", "gamg", "-pc_gamg_setup", "stream", "-pc_gamg_coarse_eq_limit", "100", "-ksp_rtol", "1e-8",
              "-ksp_converged_reason", "-dist", "-no_vtk"]


def gamg_rank(side=704):
    """One rank of `gamg`, under torchrun: the distributed gamg on the
    side^2 Q1 DistAIJ in f64, each setup timed (synchronized, between
    barriers) in the order global, stream, stream, global, then CG to
    rtol 1e-8 (unpreconditioned norm) once to warm and once timed; then
    rank 0's host profile of one more streaming setup (cProfile, the
    functions with the most cumulative time). Rank 0 prints."""
    import cProfile
    import io
    import pstats

    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.models import poisson
    from saddle_point_petsc_tpu_torch.ops import sparse
    from saddle_point_petsc_tpu_torch.parallel import dist_csr
    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
    from saddle_point_petsc_tpu_torch.solvers import amg, krylov

    dev, created = pmesh.init_from_env(torch.device("cuda"))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = dist_csr.make_mesh_1d(dev)
        csr, f, _, _ = poisson.assemble_poisson_csr(side - 1, side - 1, dtype=torch.float64, device=dev)
        A = dist_csr.dist_aij_from_scipy(sparse.csr_to_scipy(csr), mesh)
        b = dist_csr.pad_vector(f, A.n_pad, mesh)
        del csr

        def timed(fn):
            dist.barrier(device_ids=[dev.index])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dist.barrier(device_ids=[dev.index])
            return out, time.perf_counter() - t0

        lines = []
        for setup in ("global", "stream", "stream", "global"):
            M, t_setup = timed(lambda: amg.dist_amg_pc(A, setup=setup))

            def solve():
                return krylov.cg(A, b, M=M, rtol=1e-8, maxiter=200, norm_type="unpreconditioned")

            solve()
            res, t_solve = timed(solve)
            its = res.iterations
            lines.append(f"{side}^2 f64 CG + gamg, setup={setup}, on {world} rank(s): {its} its, "
                         f"{res.reason_name()}, PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, "
                         f"{t_solve / its * 1e3:.3f} ms/it, levels {[lvl.A.shape[0] for lvl in M.levels]}")
            del M
        prof = cProfile.Profile() if rank == 0 else None
        if prof:
            prof.enable()
        amg.dist_amg_pc(A, setup="stream")
        if rank == 0:
            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(r"(amg|dist_csr)\.py", 20)
            card = _card()
            for ln in lines:
                print(f"{ln} ({card}, each rank its own card)")
            print(f"rank 0's host profile of one streaming setup on {world} rank(s):")
            print(text.getvalue())
    finally:
        if created:
            dist.destroy_process_group()


def gamg_runs(ranks):
    card = _card()
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {"PYTHONPATH": pkg + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    its = re.compile(r"its=(\d+), reason=(\w+)")
    with tempfile.TemporaryDirectory() as tmp:
        got = {device: its.findall(_torchrun(ranks, ["-device", device] + GAMG_SMALL, tmp, env))
               for device in ("cuda", "cpu")}
        print(f"65^2 f64 -mat_type aij -dist CG + gamg (stream) on {ranks} ranks: NCCL {got['cuda']}, gloo "
              f"{got['cpu']} ({card})")
        # the ranks' sums reduce in another order on NCCL than on gloo: counts within 1
        if abs(int(got["cuda"][0][0]) - int(got["cpu"][0][0])) > 1:
            raise SystemExit("NCCL and gloo disagree")
        for n in (ranks, 1):
            _torchrun(n, ["gamg-rank"], tmp, env, module="saddle_point_petsc_tpu_torch.tools.dist_probe")


MG_SMALL = ["-da_grid_x", "65", "-da_grid_y", "65", "-dtype", "f64", "-ksp_type", "cg", "-pc_type", "mg",
            "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-dist", "-no_vtk"]


def mg_rank(side=1025):
    """One rank of `mg`, under torchrun: mg_pc_dist on the side^2 Poisson in
    f64 (the SOR smoother), its setup timed, CG to rtol 1e-8 once to warm
    and once timed, then 20 V-cycles in a row, each step between barriers.
    Rank 0 prints."""
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
    from saddle_point_petsc_tpu_torch.solvers import krylov, multigrid

    dev, created = pmesh.init_from_env(torch.device("cuda"))
    try:
        mesh = pmesh.ProcessMesh.create(ny=side, nx=side, device=dev)
        A, f, _ = pd.assemble_poisson_dist(pd.DistGrid.create(side - 1, side - 1, mesh), dtype=torch.float64)

        def timed(fn, reps=1):
            dist.barrier(device_ids=[dev.index])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            torch.cuda.synchronize()
            dist.barrier(device_ids=[dev.index])
            return out, (time.perf_counter() - t0) / reps

        M, t_setup = timed(lambda: multigrid.mg_pc_dist(A))
        patches = [None] * mesh.size
        dist.all_gather_object(patches, [lvl.A.local_shape for lvl in M.levels])

        def solve():
            return krylov.cg(A, f, M=M, rtol=1e-8, maxiter=200)

        solve()
        res, t_solve = timed(solve)
        _, t_cycle = timed(lambda: M(f), reps=20)
        if mesh.rank == 0:
            print(f"{side}^2 f64 CG + mg_pc_dist (sor) on {mesh.size} rank(s), mesh {mesh.shape}: {res.iterations} its, "
                  f"{res.reason_name()}, PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, "
                  f"{t_solve / res.iterations * 1e3:.3f} ms/it, V-cycle {t_cycle * 1e3:.3f} ms; split levels "
                  f"{[lvl.A.grid_shape[0] for lvl in M.levels]}, gathered {M.tiling.shape}; patches by rank "
                  f"{patches} ({_card()}, each rank its own card)")
    finally:
        if created:
            dist.destroy_process_group()


def mg_runs(ranks):
    card = _card()
    shape = f"2,{ranks // 2}" if ranks > 1 else "1,1"
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {"PYTHONPATH": pkg + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    its = re.compile(r"its=(\d+), reason=(\w+)")
    with tempfile.TemporaryDirectory() as tmp:
        got = {device: its.findall(_torchrun(ranks, ["-device", device, "-mesh", shape] + MG_SMALL, tmp, env))
               for device in ("cuda", "cpu")}
        print(f"65^2 f64 -dist CG + mg on a {shape} mesh: NCCL {got['cuda']}, gloo {got['cpu']} ({card})")
        if got["cuda"] != got["cpu"]:
            raise SystemExit("NCCL and gloo disagree")
        for n in (ranks, 1):
            _torchrun(n, ["mg-rank"], tmp, env, module="saddle_point_petsc_tpu_torch.tools.dist_probe")


def true_rel_kkt(planes, Bf, rhs, x, active=None):
    """|rhs - K x| / |rhs| in f64 through the plain serial stencil matvec,
    on the (ny, nx) active grid of global (gathered, possibly padded)
    arrays (None: all of it): a check that shares no code with
    solvers/refine.py or the distributed operators."""
    from saddle_point_petsc_tpu_torch.ops.stencil import planes_matvec_field
    from saddle_point_petsc_tpu_torch.solvers import krylov
    from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator

    ny, nx = active or planes.shape[-2:]

    def crop(t):
        return t[..., :ny, :nx].double().contiguous()

    planes = crop(planes)
    K = SaddleOperator(lambda u: planes_matvec_field(planes, u), crop(Bf))
    b = (crop(rhs[0]), rhs[1].double())
    return (krylov.tnorm(krylov.tsub(b, K((crop(x[0]), x[1].double())))) / krylov.tnorm(b)).item()


def refine_rank(side=1025, device="cuda"):
    """One rank of `refine`, under torchrun: the side^2 trig KKT system in
    f64 on the mesh decide_process_grid picks, refined to rtol 1e-8 with
    config 5's inner solve (`minres-mg`, at most 20000 iterations); each
    step timed between barriers. Rank 0 prints `cycles=C, its=I` and the
    f64 true relative residual of the gathered solution (the active grid,
    through the plain serial matvec)."""
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.parallel import dist as pd
    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
    from saddle_point_petsc_tpu_torch.solvers import refine

    dev, created = pmesh.init_from_env(torch.device(device))
    cuda = dev.type == "cuda"
    try:
        mesh = pmesh.ProcessMesh.create(ny=side, nx=side, device=dev)

        def timed(fn):
            dist.barrier(device_ids=[dev.index] if cuda else None)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            dist.barrier(device_ids=[dev.index] if cuda else None)
            return out, time.perf_counter() - t0

        def setup():
            K32 = refine.kkt_f32(K)
            return K32, refine.refine_inner(K32, "minres-mg")

        (K, rhs, _), t_asm = timed(lambda: pd.assemble_saddle_dist(pd.DistGrid.create(side - 1, side - 1, mesh),
                                                                   body_force="trig"))
        (K32, kw), t_setup = timed(setup)
        (x, cycles, its, rn, rn0), t_solve = timed(refine.solve_refined_kkt_fused(
            K32, rhs, planes_df=K.A.planes, Bf_df=K.Bf, inner_rtol=1e-3, inner_maxiter=20000, **kw))
        planes, Bf, f, u = (pmesh.gather_field(t, mesh) for t in (K.A.planes, K.Bf, rhs[0], x[0]))
        if mesh.rank == 0:
            true_rel = true_rel_kkt(planes, Bf, (f, rhs[1]), (u, x[1]), (side, side))
            where = f"{_card()}, each rank its own card" if cuda else "gloo on the CPU"
            print(f"{side}^2 refinement, minres-mg inner, on {mesh.size} rank(s), mesh {mesh.shape}: cycles={cycles}, "
                  f"its={its}, Assembly {t_asm:.3f} s, PCSetUp {t_setup:.3f} s, solve {t_solve:.4f} s, "
                  f"|r|/|b| {rn / rn0:.3e} (loop), true relative residual {true_rel:.3e} (f64, plain, gathered) "
                  f"({where})", flush=True)
    finally:
        if created:
            dist.destroy_process_group()


def refine_runs(ranks):
    card = _card()
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {"PYTHONPATH": pkg + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    line = re.compile(r"cycles=(\d+), its=(\d+).*true relative residual (\S+)")
    with tempfile.TemporaryDirectory() as tmp:
        module = "saddle_point_petsc_tpu_torch.tools.dist_probe"
        got = {device: line.findall(_torchrun(ranks, ["refine-rank", "--side", "65", "--device", device], tmp, env,
                                              module=module))[0][:2]
               for device in ("cuda", "cpu")}
        print(f"65^2 refinement (minres-mg) on {ranks} ranks: NCCL cycles, its {got['cuda']}, gloo {got['cpu']} "
              f"({card})")
        if got["cuda"] != got["cpu"]:
            raise SystemExit("NCCL and gloo disagree")
        out = {n: line.findall(_torchrun(n, ["refine-rank"], tmp, env, module=module))[0] for n in (ranks, 1)}
        (c4, _, r4), (c1, _, _) = out[ranks], out[1]
        print(f"1025^2 refinement (minres-mg): {c4} cycles on {ranks} ranks, {c1} on one, true relative residual "
              f"{r4} on {ranks} ({card})")
        if abs(int(c4) - int(c1)) > 1 or not float(r4) <= 1e-8:
            raise SystemExit("the refinement on several ranks misses 1e-8 or the one-rank cycle count")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("overhead", "cli", "mesh", "aij", "aij-rank", "gamg", "gamg-rank", "mg",
                                     "mg-rank", "refine", "refine-rank"))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--side", type=int, default=1025, help="refine-rank: nodes a side")
    ap.add_argument("--device", default="cuda", help="refine-rank: cuda (NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)
    if args.mode == "overhead":
        overhead()
    elif args.mode == "cli":
        cli_runs(args.repeats)
    elif args.mode == "aij":
        aij_runs(args.ranks)
    elif args.mode == "aij-rank":
        aij_rank()
    elif args.mode == "gamg":
        gamg_runs(args.ranks)
    elif args.mode == "gamg-rank":
        gamg_rank()
    elif args.mode == "mg":
        mg_runs(args.ranks)
    elif args.mode == "mg-rank":
        mg_rank()
    elif args.mode == "refine":
        refine_runs(args.ranks)
    elif args.mode == "refine-rank":
        refine_rank(args.side, args.device)
    else:
        mesh_runs(args.ranks)


if __name__ == "__main__":
    main()
