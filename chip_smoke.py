#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each passes or raises; the script exits non-zero on any failure):

1. Environment: torch/CUDA versions, the card's name and power limit
   (nvidia-smi), nvcc's version. Exits 1 without a CUDA device.
2. Build: compile csrc/stencil_spmv.cu with nvcc for sm_90a (or load the
   build keyed on the source's hash) and report the time.
3. Kernel B1 against its plain PyTorch version on the card: f32 and f64,
   both entry points, node grids 4x4 to 1025x1025 (the main path's among
   them) with planes from assemble_poisson(body_force="trig") and random
   planes; then both timed at 1025^2 with CUDA events (median of 60
   launches).
4. Main path, f64, 257^2 nodes: the CLI's saddle route to rtol 1e-8,
   counting B1 launches; true residual in f64; the same solve with the
   plain matvec in place of the kernel.
5. Main path, f32, 1025^2 nodes to rtol 1e-5, and 256^2 nodes (the JAX
   bench's kkt_solve configuration) beside its recorded 452 iterations.

The last lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from saddle_point_petsc_tpu_torch import cli
from saddle_point_petsc_tpu_torch.models import poisson
from saddle_point_petsc_tpu_torch.ops.cuda import _build, spmv
from saddle_point_petsc_tpu_torch.solvers import krylov, precond
from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator

# (nx, ny) nodes: ragged small grids up to 1025^2, the main path's 256^2 and 257^2 among them
GRIDS = ((4, 4), (7, 5), (33, 17), (257, 129), (256, 256), (257, 257), (1025, 1025))
# Kernel and plain version sum the same 36 products in the same order;
# only FMA contraction differs, so they agree to a few ulps of max|y|.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
BENCH_R04_KKT_ITERATIONS = 452  # BENCH_r04.json kkt_iterations (256^2, f32, rtol 1e-5)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _median_ms(fn, n=60, warmup=5):
    """Median device time of one call, from CUDA events around each call.
    A sleep kernel queued first lets the host run ahead, so the events
    time the device work and not the Python launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_kernel(dev, card):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for nx, ny in GRIDS:
            assembled = poisson.assemble_poisson(
                nx - 1, ny - 1, dtype=dtype, device=dev, body_force="trig"
            ).A.planes
            # random planes too: a uniform-grid operator has planes[1] ==
            # planes[2] and would hide a swapped dof coupling
            rand = torch.randn(assembled.shape, generator=gen, dtype=dtype, device=dev)
            x = torch.randn((2, ny, nx), generator=gen, dtype=dtype, device=dev)
            xp = torch.randn((2, ny + 2, nx + 2), generator=gen, dtype=dtype, device=dev)
            for entry, kernel, plain, arg, planes in (
                ("zero", spmv.stencil_spmv, spmv.planes_matvec_field, x, assembled),
                ("padded", spmv.stencil_spmv_padded, spmv.planes_matvec_padded, xp, assembled),
                ("zero/random-planes", spmv.stencil_spmv, spmv.planes_matvec_field, x, rand),
                ("padded/random-planes", spmv.stencil_spmv_padded, spmv.planes_matvec_padded, xp, rand),
            ):
                yk = kernel(planes, arg)
                yp = plain(planes, arg)
                torch.cuda.synchronize()
                err = (yk - yp).abs().max().item()
                scale = yp.abs().max().item()
                ok = err <= TOL[dtype] * scale
                print(
                    f"B1 {str(dtype)[6:]:<8} {nx:>5}x{ny:<5} {entry:<20} "
                    f"max|dy|={err:.3e} max|y|={scale:.3e} "
                    f"rel={err / scale:.3e} tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}"
                )
                if not ok:
                    raise AssertionError(f"B1 disagrees with its plain version: {nx}x{ny} {dtype} {entry}")
                max_err = max(max_err, err)

    timings = {}
    nx = ny = 1025
    for dtype in (torch.float32, torch.float64):
        planes = poisson.assemble_poisson(
            nx - 1, ny - 1, dtype=dtype, device=dev, body_force="trig"
        ).A.planes
        x = torch.randn((2, ny, nx), generator=gen, dtype=dtype, device=dev)
        t_plain1 = _median_ms(lambda: spmv.planes_matvec_field(planes, x))
        t_kern1 = _median_ms(lambda: spmv.stencil_spmv(planes, x))
        t_kern2 = _median_ms(lambda: spmv.stencil_spmv(planes, x))
        t_plain2 = _median_ms(lambda: spmv.planes_matvec_field(planes, x))
        nbytes = 40 * planes.element_size() * ny * nx
        nnz = 36 * ny * nx
        t_kern, t_plain = min(t_kern1, t_kern2), min(t_plain1, t_plain2)
        for name, t in (("kernel", t_kern), ("plain", t_plain)):
            print(
                f"B1 time {str(dtype)[6:]:<8} {nx}x{ny} {name:<6} {t * 1e3:9.2f} us "
                f"{nbytes / t / 1e6:8.1f} GB/s {nnz / t / 1e6:7.2f} Gnnz/s  ({card})"
            )
        print(
            f"  medians of 60 in turn (plain, kernel, kernel, plain): {t_plain1 * 1e3:.2f} "
            f"{t_kern1 * 1e3:.2f} {t_kern2 * 1e3:.2f} {t_plain2 * 1e3:.2f} us"
        )
        timings[dtype] = (t_kern, t_plain)
    return max_err, timings


def _cli(argv):
    """One in-process CLI run; returns (CliRun, B1 launches during it)."""
    print("$ python -m saddle_point_petsc_tpu_torch.cli " + " ".join(argv), flush=True)
    spmv.reset_launches()
    run = cli.run(argv)
    launches = spmv.launches
    res = run.result
    print(f"B1 launches {launches}, iterations {res.iterations}, reason {res.reason_name()}")
    if run.rc != 0 or res.reason_name() != "CONVERGED_RTOL":
        raise AssertionError(f"CLI run did not converge: rc={run.rc} {res.reason_name()}")
    if launches < res.iterations:
        raise AssertionError(f"B1 launched {launches} times for {res.iterations} iterations")
    return run, launches


def phase_f64(tmp):
    vtk_path = os.path.join(tmp, "saddle_257.vtk")
    run, launches = _cli([
        "-device", "cuda", "-problem_type", "saddle", "-body_force", "trig",
        "-da_grid_x", "257", "-da_grid_y", "257", "-dtype", "f64",
        "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-log_view", "-vtk", vtk_path,
    ])
    prob, res = run.problem, run.result
    r = krylov.tsub(prob.rhs, prob.K(res.x))
    true_rel = (krylov.tnorm(r) / krylov.tnorm(prob.rhs)).item()
    print(f"true residual |Kx - rhs|/|rhs| = {true_rel:.3e} (f64)")
    if not true_rel <= 1e-6:
        raise AssertionError(f"true residual {true_rel} > 1e-6")
    if not os.path.exists(vtk_path):
        raise AssertionError("the CLI wrote no VTK file")

    # the same assembled problem with the plain matvec in place of B1
    planes = prob.A.planes
    K_plain = SaddleOperator(lambda u: spmv.planes_matvec_field(planes, u), prob.Bf)
    M = precond.schur_pc(prob.A, prob.Bf, fact_type="diag")
    t0 = time.perf_counter()
    res_p = krylov.minres(K_plain, prob.rhs, M=M, rtol=1e-8, maxiter=10000)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    dx = (krylov.tnorm(krylov.tsub(res.x, res_p.x)) / krylov.tnorm(res_p.x)).item()
    t_solve = run.log.phases["KSPSolve"].total_s
    print(
        f"257^2 f64 MINRES: kernel {res.iterations} its {t_solve:.4f} s "
        f"({t_solve / res.iterations * 1e3:.4f} ms/it); plain matvec "
        f"{res_p.iterations} its {t_plain:.4f} s ({t_plain / res_p.iterations * 1e3:.4f} ms/it); "
        f"|x_kernel - x_plain|/|x_plain| = {dx:.3e}"
    )
    if res_p.reason_name() != "CONVERGED_RTOL" or abs(res_p.iterations - res.iterations) > 2:
        raise AssertionError(f"plain solve: {res_p.reason_name()} in {res_p.iterations} its")
    if not dx <= 1e-6:
        raise AssertionError(f"kernel and plain solutions differ by {dx}")
    return launches


def phase_f32(tmp):
    for n in (1025, 256):
        run, _ = _cli([
            "-device", "cuda", "-problem_type", "saddle", "-body_force", "trig",
            "-da_grid_x", str(n), "-da_grid_y", str(n), "-dtype", "f32",
            "-ksp_rtol", "1e-5", "-ksp_converged_reason", "-log_view",
            "-vtk", os.path.join(tmp, f"saddle_{n}.vtk"),
        ])
        its = run.result.iterations
        t = run.log.phases["KSPSolve"].total_s
        print(f"{n}^2 f32 MINRES: {its} its, solve {t:.4f} s, {t / its * 1e3:.4f} ms/it")
        if n == 256:
            print(f"256^2 f32 iterations {its} beside {BENCH_R04_KKT_ITERATIONS} in BENCH_r04.json")
            if abs(its - BENCH_R04_KKT_ITERATIONS) > 0.2 * BENCH_R04_KKT_ITERATIONS:
                raise AssertionError(f"{its} iterations, not within 20% of {BENCH_R04_KKT_ITERATIONS}")


def main():
    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = _card_line()
    print(f"card: {card}")
    nvcc = _build.find_nvcc()
    print(subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)

    _build.load_library()
    info = _build.build_info()
    print(f"build: {info.seconds:.2f} s, {info.path}")
    print("  " + " ".join(info.command) if info.command else "  (loaded an existing build)")
    print(info.log.strip())

    max_err, timings = phase_kernel(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_f64(tmp)
        phase_f32(tmp)

    k32, p32 = timings[torch.float32]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "stencil_spmv (B1)",
        "route": "cuda",
        "source": "saddle_point_petsc_tpu_torch/csrc/stencil_spmv.cu",
        "replaces": "saddle_point_petsc_tpu/ops/pallas/spmv.py:44",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k32,
        "plain_ms": p32,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
