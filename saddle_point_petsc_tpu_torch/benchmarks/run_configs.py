"""BASELINE.md benchmark configurations 1-4, one JSON line each (PyTorch
twin of the repository's benchmarks/run_configs.py).

  1. 64x64 saddle point, MINRES + block-Jacobi PC
  2. same system, fieldsplit Schur (diag(A)), GMRES outer
  3. 256x256 block operator, FGMRES + inner-CG Schur (also `3mg`, the MG
     A-solve, and `3bsr`, the A block stored and applied as 2x2 BSR blocks)
  4. ~1M-row KKT patch-partitioned over the process group's mesh (a world
     of one started here without one), halo-exchanging SpMV

Configs 1 and 2 run in float64 (the JAX package's default type); 3 and 4
in float32 to rtol 1e-5 on the card, float64 to 1e-8 on the CPU. Each
solve is timed on the host clock between synchronizations after one warm
run.

Usage: python -m saddle_point_petsc_tpu_torch.benchmarks.run_configs
    [--cpu] [--configs=1,2,3,3mg,3bsr,4]   (BENCH_CPU=1 also picks the CPU)
"""
from __future__ import annotations

import json
import os
import sys

import torch

from saddle_point_petsc_tpu_torch.benchmarks import harness
from saddle_point_petsc_tpu_torch.models import poisson, saddle
from saddle_point_petsc_tpu_torch.ops import sparse as sp
from saddle_point_petsc_tpu_torch.ops.stencil import field_to_flat
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.solvers import krylov, multigrid, precond
from saddle_point_petsc_tpu_torch.utils.device import card_line


def _report(name, seconds, its, rrel, device, extra=None):
    out = {"config": name, "seconds": seconds, "iterations": int(its), "rel_rnorm": float(rrel),
           "device": card_line(device)}
    out.update(extra or {})
    print(json.dumps(out))
    return out


def _dtype(device):
    """float32 on the card, float64 on the CPU (run_configs.py:146-148)."""
    return torch.float32 if device.type == "cuda" else torch.float64


def _rtol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-8


def _solve(solve, device):
    t, res = harness.timed_solve(solve, device)
    return t, res.iterations, res.rnorm / res.rnorm0


def config1(n=64, device=None):
    """n x n elements, MINRES + block-Jacobi (8 strips) on A and the
    Schur(diag) inverse on lambda, to rtol 1e-8 (BASELINE config 1)."""
    dev = device or harness.bench_device()
    prob = saddle.assemble_saddle(n, n, device=dev, body_force="trig")
    Mu = precond.block_jacobi_stencil(prob.A, nblocks=8)
    Si = precond.schur_pc(prob.A, prob.Bf, fact_type="diag")

    def M(r):
        ru, rlam = r
        return (Mu(ru), -(Si.S_inv @ rlam))

    return _report("1:64x64-minres-bjacobi", *_solve(
        lambda: krylov.minres(prob.K, prob.rhs, M=M, rtol=1e-8, maxiter=3000), dev), dev)


def config2(n=64, device=None):
    """The same system, Schur(full, diag(A)) fieldsplit under GMRES(30) to
    rtol 1e-8 (BASELINE config 2)."""
    dev = device or harness.bench_device()
    prob = saddle.assemble_saddle(n, n, device=dev, body_force="trig")
    M = precond.schur_pc(prob.A, prob.Bf, fact_type="full")
    return _report("2:64x64-gmres-schur", *_solve(
        lambda: krylov.gmres(prob.K, prob.rhs, M=M, rtol=1e-8, maxiter=2000, restart=30), dev), dev)


def config3(n=256, dtype=None, device=None):
    """n x n elements, FGMRES(30) + Schur(full) whose A-solve is an inner CG
    (one MG V-cycle as its PC, rtol 1e-2, at most 10 iterations)."""
    dev = device or harness.bench_device()
    dtype = dtype or _dtype(dev)
    prob = saddle.assemble_saddle(n, n, dtype=dtype, device=dev, body_force="trig")
    inner = precond.KSPInnerPC(prob.A, multigrid.mg_pc(prob.A), solver="cg", rtol=1e-2, maxiter=10)
    M = precond.schur_pc(prob.A, prob.Bf, inner_solve=inner, fact_type="full")
    return _report("3:256x256-fgmres-innercg", *_solve(
        lambda: krylov.fgmres(prob.K, prob.rhs, M=M, rtol=_rtol(dtype), maxiter=500, restart=30), dev), dev,
        {"dtype": str(dtype).removeprefix("torch.")})


def config3_mg(n=256, device=None):
    """n x n elements, FGMRES(30) + Schur(full) with one MG V-cycle as the
    A-solve."""
    dev = device or harness.bench_device()
    dtype = _dtype(dev)
    prob = saddle.assemble_saddle(n, n, dtype=dtype, device=dev, body_force="trig")
    M = precond.schur_pc(prob.A, prob.Bf, inner_solve=multigrid.mg_pc(prob.A), fact_type="full")
    return _report("3mg:256x256-fgmres-mgschur", *_solve(
        lambda: krylov.fgmres(prob.K, prob.rhs, M=M, rtol=_rtol(dtype), maxiter=200, restart=30), dev), dev,
        {"dtype": str(dtype).removeprefix("torch.")})


def config3_bsr(n=256, device=None):
    """Config 3 as BASELINE.md words it: the A block stored and applied as
    2x2 BSR blocks on the flat dof-interleaved vector, FGMRES(30) with MG
    Schur(full) A-solves; then the raw SpMV rates of the BSR, block-DIA
    (kernel B4) and stencil (kernel B1) matvecs of that operator, each a
    chain of 100 and 200 matvecs scaled by 0.05."""
    dev = device or harness.bench_device()
    dtype = _dtype(dev)
    prob = saddle.assemble_saddle(n, n, dtype=dtype, device=dev, body_force="trig")
    csr = poisson.assemble_poisson_csr(n, n, dtype=dtype, device=dev)[0]
    bsr = sp.csr_to_bsr(csr, block=2)
    B = prob.K.B
    d = sp.csr_extract_diagonal(csr)
    dinv = 1.0 / torch.where(d == 0, 1.0, d)
    S_inv = precond.inv_small(-torch.einsum("mi,i,ki->mk", B, dinv, B))
    mg = multigrid.mg_pc(prob.A)

    def K(v):
        u, lam = v
        return (sp.bsr_matvec(bsr, u) + B.T @ lam, B @ u)

    def M(r):
        ru, rlam = r
        yu = mg(ru)
        zlam = S_inv @ (rlam - B @ yu)
        return (yu - mg(B.T @ zlam), zlam)

    rhs = (field_to_flat(prob.f), prob.g)
    t, its, rrel = _solve(lambda: krylov.fgmres(K, rhs, M=M, rtol=_rtol(dtype), maxiter=200, restart=30), dev)
    nnz = int(bsr.nnzb) * 4
    u0 = rhs[0]

    def rate(mv):
        return harness.chain_rate(lambda v: mv(v) * 0.05, u0, nnz, 100, dev)[0]

    bdia = sp.bsr_to_bdia(bsr)
    return _report("3bsr:256x256-fgmres-mgschur-bsr", t, its, rrel, dev, {
        "dtype": str(dtype).removeprefix("torch."),
        "bsr_nnz_per_s": rate(lambda v: sp.bsr_matvec(bsr, v)),
        "bdia_nnz_per_s": rate(lambda v: sp.bdia_matvec(bdia, v)),
        "stencil_nnz_per_s": rate(prob.A.matvec),
    })


def config4(n=704, device=None):
    """n^2 nodes (991,236 KKT rows at 704), patch-partitioned over the
    process group's mesh: MINRES + Schur(diag) whose A-block solve is the
    per-patch block-Jacobi (4 Chebyshev iterations), PETSc's parallel
    defaults (BASELINE config 4). The rate counts 1 + 4 matvecs an
    iteration."""
    dev = device or harness.bench_device()
    dtype = _dtype(dev)
    with harness.world(dev) as dev:
        mesh = pmesh.ProcessMesh.create(ny=n, nx=n, device=dev)
        grid = pdist.DistGrid.create(n - 1, n - 1, mesh)
        K, rhs, _ = pdist.assemble_saddle_dist(grid, dtype=dtype, body_force="trig")
        M = precond.schur_pc(K.A, K.Bf, pdist.dist_block_jacobi(K.A, iters=4), fact_type="diag")
        t, its, rrel = _solve(lambda: krylov.minres(K, rhs, M=M, rtol=_rtol(dtype), maxiter=3000), dev)
        return _report("4:dist-kkt-halo-overlap", t, its, rrel, dev, {
            "rows": grid.ny * grid.nx * 2 + K.Bf.shape[0],
            "devices": mesh.size,
            "pc": "schur(diag) + per-patch bjacobi/chebyshev",
            "nnz_per_s": grid.ny * grid.nx * 36 * 5 * max(its, 1) / t,
        })


CONFIGS = {"1": config1, "2": config2, "3": config3, "3mg": config3_mg, "3bsr": config3_bsr, "4": config4}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cpu") if "--cpu" in argv or os.environ.get("BENCH_CPU") else harness.bench_device()
    which = "1,2,3,3mg,3bsr,4"
    for a in argv:
        if a.startswith("--configs="):
            which = a.split("=", 1)[1]
    for k in which.split(","):
        CONFIGS[k.strip()](device=dev)


if __name__ == "__main__":
    main()
