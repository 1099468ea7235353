"""Entry hooks (PyTorch twin of the JAX package's `__graft_entry__.py`).

    python -m saddle_point_petsc_tpu_torch.graft_entry [--device cpu]
    python -m saddle_point_petsc_tpu_torch.graft_entry --dryrun [--device cpu]
    torchrun --nproc_per_node 4 -m saddle_point_petsc_tpu_torch.graft_entry --dryrun [--device cpu]

entry(): the single-device step, MINRES + Schur(diag) on the 32 x 32 f32
KKT system. dryrun_multichip(): BASELINE config 5's full PC stack in the
initialized process group, of any size: the SPMD assembly, MINRES with
Schur(diag) and per-patch ILU(0), and CG on a row-partitioned Poisson
DistAIJ under the distributed gamg with the streaming setup. Without
torchrun, --dryrun runs in a world of one. The default device is the card.
"""
from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as dist

from saddle_point_petsc_tpu_torch.models import saddle
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import dist_csr
from saddle_point_petsc_tpu_torch.parallel.mesh import ProcessMesh, decide_process_grid, init_from_env
from saddle_point_petsc_tpu_torch.solvers import krylov, precond
from saddle_point_petsc_tpu_torch.solvers.amg import dist_amg_pc
from saddle_point_petsc_tpu_torch.solvers.ilu_stencil import dist_ilu0


def entry(device=None):
    """(step, (K, rhs)): the KKT solve step, MINRES + Schur(diag) to rtol
    1e-5 in at most 25 iterations, and its 32 x 32-element f32 system
    with the trig body force, on `device` (None: the card)."""
    prob = saddle.assemble_saddle(32, 32, dtype=torch.float32, device=device, body_force="trig")

    def step(K, rhs):
        M = precond.schur_pc(K.A, K.Bf, fact_type="diag")
        res = krylov.minres(K, rhs, M=M, rtol=1e-5, maxiter=25)
        return res.x, res.rnorm

    return step, (prob.K, (prob.f, prob.g))


def dryrun_multichip(device=None):
    """One distributed KKT step over the world's ranks, with the full
    config-5 PC stack, then a distributed-gamg CG on a DistAIJ; returns
    {"minres_rnorm", "minres_its", "cg_its", "cg_rnorm", "cg_levels"}.

    The process grid is `decide_process_grid(world)`, with enough nodes
    for 4 a rank along each axis. The saddle system is assembled twice
    (parallel/dist.py): in f64, standing in for the JAX package's
    double-float assembly (the card has f64), and in f32; they must agree
    to f32 accuracy. Its planes cast to f32 (the role of the JAX df.hi)
    then take 5 MINRES iterations at rtol 1e-3, Schur(diag) with a
    per-patch ILU(0) A-block (4 sweeps). Then CG (rtol 1e-4, at most 20
    iterations) on the max(4 world, 16)^2 5-point Poisson matrix in f32,
    row-partitioned over a 1-D mesh, under `dist_amg_pc(setup="stream",
    coarse_max=64)`. Collective: every rank calls it."""
    world = dist.get_world_size()
    mesh = ProcessMesh.create(decide_process_grid(world), device=device)
    nex, ney = 4 * mesh.px - 1, 4 * mesh.py - 1
    grid = pdist.DistGrid.create(nex, ney, mesh)
    K64, (f64, g64), _ = pdist.assemble_saddle_dist(grid, dtype=torch.float64, body_force="trig")
    K32, _, _ = pdist.assemble_saddle_dist(grid, dtype=torch.float32, body_force="trig")
    p64 = K64.A.planes
    worst = torch.stack([(p64 - K32.A.planes.double()).abs().max(), p64.abs().max()])
    dmax, pmax = mesh.all_reduce(worst, op=dist.ReduceOp.MAX).tolist()
    assert dmax / pmax < 1e-5, f"f64 vs f32 SPMD assembly diverge: {dmax / pmax}"
    Ad = pdist.DistStencilOperator(p64.float(), mesh, active_shape=(ney + 1, nex + 1))
    K = pdist.DistSaddleOperator(Ad, K64.Bf.float())
    M = precond.schur_pc(K.A, K.Bf, dist_ilu0(K.A, sweeps=4), fact_type="diag")
    res = krylov.minres(K, (f64.float(), g64.float()), M=M, rtol=1e-3, maxiter=5)
    x_u, _ = res.x
    assert x_u.shape == (2, grid.my, grid.mx)
    assert np.isfinite(res.rnorm)

    # the general-sparse twin: MATMPIAIJ's all_to_all ghost scatter under
    # the distributed gamg, built by the streaming setup (each rank's rows)
    n1 = max(4 * world, 16)
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n1, n1))
    a = (sps.kron(sps.identity(n1), t) + sps.kron(t, sps.identity(n1))).tocsr().astype(np.float32)
    mesh1 = dist_csr.make_mesh_1d(device=mesh.device)
    A = dist_csr.dist_aij_from_scipy(a, mesh1)
    Mg = dist_amg_pc(A, setup="stream", coarse_max=64)
    b = dist_csr.pad_vector(np.ones(a.shape[0], np.float32), A.n_pad, mesh1)
    cg = krylov.cg(A, b, M=Mg, rtol=1e-4, maxiter=20)
    assert np.isfinite(cg.rnorm)
    return {"minres_rnorm": res.rnorm, "minres_its": res.iterations, "cg_its": cg.iterations,
            "cg_rnorm": cg.rnorm, "cg_levels": [lvl.A.shape[0] for lvl in Mg.levels]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", action="store_true", help="run dryrun_multichip() over the process group")
    ap.add_argument("--device", default="cuda", help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    args = ap.parse_args(argv)
    if not args.dryrun:
        step, operands = entry(args.device)
        (x_u, x_lam), rnorm = step(*operands)
        print(f"entry ok: x {tuple(x_u.shape)} {tuple(x_lam.shape)}, rnorm {rnorm:.3e}")
        return 0
    device, created = init_from_env(args.device)
    try:
        out = dryrun_multichip(device)
        if dist.get_rank() == 0:
            print(f"dryrun_multichip ok over {dist.get_world_size()} ranks: {out}")
    finally:
        if created:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
