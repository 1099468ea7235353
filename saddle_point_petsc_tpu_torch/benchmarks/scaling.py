"""Scaling efficiency of the distributed stencil SpMV: nnz/s on N ranks
against one rank on one global grid (PyTorch twin of the repository's
benchmarks/scaling.py).

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m saddle_point_petsc_tpu_torch.benchmarks.scaling [n_nodes=1024] [reps=10] [--device cuda|cpu]

One rank a card over NCCL (`--device cuda`, the default), or one process
a rank over gloo on the CPU (`--device cpu`, one thread each: the port's
bench runs it so, as the JAX bench runs its fake-device CPU mesh). Rank 0
prints one JSON line. Without torchrun: a world of one.

Each rank holds its patch of the n^2 Poisson planes (float32, pre-scaled
by 8 power steps); the 1-rank figure is rank 0 alone on the whole grid
while the others wait. Per round, each of the 1-rank chain, the N-rank
overlap form (`DistStencilOperator.matvec_field`: B1 on the patch while
the exchange is in flight, then edge corrections), the N-rank overlap-off
form (the exchange, then B1's padded entry) and the N-rank compute-only
form (B1 on the patch, no exchange) runs r and 2r dependent matvecs
between barriers on the host clock; five rounds, interleaved. Efficiency
is N-rank throughput over N times 1-rank throughput: each rank brings its
own card (NCCL) or CPU thread (gloo), so the ideal is N x. On gloo the N
processes share one host's memory bandwidth: a plumbing number. The
N-rank float64 product of a random vector is held to the serial one of
the gathered planes (`scaling_matvec_max_err`, relative to max|y|).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as tdist

from saddle_point_petsc_tpu_torch.benchmarks import harness
from saddle_point_petsc_tpu_torch.ops.cuda.spmv import stencil_spmv, stencil_spmv_padded
from saddle_point_petsc_tpu_torch.ops.stencil import planes_matvec_field
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import dist_csr
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.parallel.halo import halo_exchange_1phase
from saddle_point_petsc_tpu_torch.utils.device import card_line

ROUNDS = 5


def _barrier(dev):
    tdist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)


def _timer(step, x, dev, everyone=True):
    """timed(r): seconds of r dependent steps from x, between barriers (on
    every rank) or on this rank alone."""

    def timed(r):
        if everyone:
            _barrier(dev)
        harness.sync(dev)
        t0 = time.perf_counter()
        v = x
        for _ in range(r):
            v = step(v)
        harness.sync(dev)
        if everyone:
            _barrier(dev)
        return time.perf_counter() - t0

    timed(1)
    return timed


def _backend():
    return "nccl" if tdist.get_backend() == "nccl" else "gloo-cpu"


def measure(n_nodes=512, reps=20, device=None):
    """The scaling keys of the JAX harness (benchmarks/scaling.py:183-206)
    plus `scaling_backend` and `scaling_matvec_max_err`, on every rank of
    the initialized process group."""
    dev = device or harness.bench_device()
    mesh = pmesh.ProcessMesh.create(ny=n_nodes, nx=n_nodes, device=dev)
    ndev, rank0 = mesh.size, mesh.rank == 0
    nnz = n_nodes * n_nodes * 36

    def operator(m):
        A, f, _ = pdist.assemble_poisson_dist(pdist.DistGrid.create(n_nodes - 1, n_nodes - 1, m), dtype=torch.float32)
        planes, x = harness.prescale(A, f, steps=8)
        return dataclasses.replace(A, planes=planes), x

    An, xn = operator(mesh)
    timers = {
        "rn": _timer(An.matvec_field, xn, dev),
        "rn_off": _timer(lambda v: stencil_spmv_padded(An.planes, halo_exchange_1phase(v, mesh)), xn, dev),
        "rn_nocomm": _timer(lambda v: stencil_spmv(An.planes, v), xn, dev),
    }
    if rank0:  # one rank on the whole grid: a 1 x 1 mesh calls no collective
        A1, x1 = operator(pmesh.ProcessMesh(1, 1, 0, 0, dev))
        timers = {"r1": _timer(A1.matvec_field, x1, dev, everyone=False), **timers}
    dts = {k: [] for k in ("r1", "rn", "rn_off", "rn_nocomm")}
    for _ in range(ROUNDS):
        _barrier(dev)
        for k, t in timers.items():
            d = (t(2 * reps) - t(reps)) / reps
            dts[k].append(d if d > 0 else float("nan"))  # non-positive: jitter swamped the round
        _barrier(dev)
    out = {
        "scaling_devices": ndev, "scaling_grid": f"{n_nodes}x{n_nodes}x2dof", "scaling_backend": _backend(),
        "scaling_halo_exchange_ms": _halo_ms(mesh, xn, reps, dev),
        "scaling_matvec_max_err": _matvec_err(An, mesh, dev),
    }
    out.update(measure_aij(n_nodes=min(n_nodes, 512), reps=max(reps // 2, 5), device=dev))
    if not rank0:
        return out
    r1, rn, rn_off, rn_nocomm = (nnz / np.nanmin(dts[k]) for k in ("r1", "rn", "rn_off", "rn_nocomm"))
    eff = [dts["r1"][i] / (ndev * min(dts["rn"][i], dts["rn_off"][i])) for i in range(ROUNDS)]
    eff = [e for e in eff if np.isfinite(e)]
    med, lo, hi = (float(f(eff)) if eff else float("nan") for f in (np.median, np.min, np.max))
    out.update({
        "scaling_nnz_per_s_1dev": r1,
        "scaling_nnz_per_s_ndev": rn,
        "scaling_nnz_per_s_ndev_overlap_off": rn_off,
        "scaling_nnz_per_s_ndev_compute_only": rn_nocomm,
        "scaling_efficiency": med,
        "scaling_eff_median": med,
        "scaling_eff_min": lo,
        "scaling_eff_max": hi,
        "scaling_eff_rounds": len(eff),
        "scaling_efficiency_overlap_on": rn / (ndev * r1),
        "scaling_efficiency_overlap_off": rn_off / (ndev * r1),
        "scaling_efficiency_compute_only": rn_nocomm / (ndev * r1),
        "scaling_matvec_ms": nnz / rn * 1e3,
        "scaling_efficiency_definition": (
            f"N-rank nnz/s over N x 1-rank nnz/s, one global grid, the better overlap form, median of "
            f"{ROUNDS} interleaved rounds; {_backend()}: "
            + ("one card a rank" if _backend() == "nccl" else
               "one CPU thread a rank, the ranks sharing one host: plumbing, not hardware scaling")
        ),
    })
    return out


def _halo_ms(mesh, x, reps, dev):
    """ms of one single-phase halo exchange, from a dependent chain of them
    (each cropped back to the patch and halved); NaN when jitter swamps it."""
    timed = _timer(lambda v: 0.5 * halo_exchange_1phase(v, mesh)[..., 1:-1, 1:-1], x, dev)
    t1 = min(timed(reps) for _ in range(3))
    t2 = min(timed(2 * reps) for _ in range(3))
    d = (t2 - t1) / reps * 1e3
    return d if d > 0 else float("nan")


def _matvec_err(A, mesh, dev):
    """max|y - y_serial| / max|y_serial| of the N-rank float64 product of a
    random vector, against the serial plain product of the gathered
    planes (on rank 0; 0.0 elsewhere)."""
    A64 = dataclasses.replace(A, planes=A.planes.double())
    gen = torch.Generator().manual_seed(0)
    xg = torch.randn((2, *A64.grid_shape), generator=gen, dtype=torch.float64)
    y = pmesh.gather_field(A64.matvec_field(A64.local_patch(xg).to(dev).contiguous()), mesh)
    planes = pmesh.gather_field(A64.planes, mesh)
    if mesh.rank != 0:
        return 0.0
    ys = planes_matvec_field(planes.cpu(), xg)
    return (y.cpu() - ys).abs().max().item() / ys.abs().max().item()


def measure_aij(n_nodes=512, reps=10, device=None):
    """DistAIJ SpMV throughput on the (1, N) mesh (the 5-point operator, a
    chain of matvecs scaled by 1/8) and its ghost count."""
    dev = device or harness.bench_device()
    mesh = dist_csr.make_mesh_1d(dev)
    a = harness.poisson5(n_nodes)
    A = dist_csr.dist_aij_from_scipy(a, mesh)
    x = dist_csr.pad_vector(np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32), A.n_pad, mesh)
    timed = _timer(lambda v: A.matvec(v) / 8.0, x, dev)
    t1 = timed(reps)
    dt = max(timed(2 * reps) - t1, 1e-9) / reps
    return {"aij_rows": a.shape[0], "aij_nnz_per_s": a.nnz / dt, "aij_ghost_count": int(A.ghost_count),
            "aij_ghost_fraction": A.ghost_count / a.shape[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_nodes", type=int, nargs="?", default=1024)
    ap.add_argument("reps", type=int, nargs="?", default=10)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, one card a rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    dev, created = pmesh.init_from_env(torch.device(args.device))
    try:
        out = measure(args.n_nodes, args.reps, dev)
        if tdist.get_rank() == 0:
            out["scaling_device"] = card_line(dev)
            print(json.dumps(out), flush=True)
    finally:
        if created:
            tdist.destroy_process_group()


if __name__ == "__main__":
    main()
