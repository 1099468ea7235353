#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each passes or raises; the script exits non-zero on any failure):

1. Environment: torch/CUDA versions, the card's name and power limit
   (nvidia-smi), nvcc's version. Exits 1 without a CUDA device.
2. Build: compile every csrc/*.cu with nvcc for sm_90a, one nvcc per
   source, all started together (or load the builds keyed on the
   sources' hashes); report each library's time and ptxas report.
3. Kernel B1 against its plain PyTorch version on the card: f32 and f64,
   both entry points, node grids 4x4 to 1025x1025 (the main path's among
   them) with planes from assemble_poisson(body_force="trig") and random
   planes; then both timed at 1025^2 with CUDA events (median of 60
   launches) beside the library call A_csr @ x (below). Then kernel RN,
   the normal draws of estimate_lmax's start vector, against its CPU twin
   (Philox words bit-equal, normals within 4 ulp, f32 and f64, odd sizes
   up to config 5's 2241^2 x 2), and the six draws of config 5's Chebyshev
   levels timed beside their 107 MB store bound, torch's CUDA normal_, the
   twin and the CPU torch.randn + copy the port made before.
4. Main path, f64, 257^2 nodes: the CLI's saddle route to rtol 1e-8,
   counting B1 launches; true residual in f64; the same solve with the
   plain matvec in place of the kernel.
5. Main path, f32, 1025^2 nodes to rtol 1e-5, and 256^2 nodes (the JAX
   bench's kkt_solve configuration) beside its recorded 452 iterations.
6. Kernels B3 (both entry names) and B4 against their plain versions, f32
   and f64: operators from assemble_poisson_csr -> csr_to_dia and
   bsr_to_bdia(csr_to_bsr) at 4x4 to 1025x1025 nodes, random bands with
   offsets such as (-300, -17, -1, 0, 3, 129, 255) and rows not a multiple
   of 32, random block bands with random active triples for b = 1, 2, 3;
   then each timed at 1025^2 beside its library call.
7. Formats agree, 257^2 f64, CG + Jacobi to rtol 1e-8 through the CLI:
   -mat_type aij, dia and bdia and the stencil route; iteration counts,
   solutions and VTK output.
8. gamg, 1025^2 nodes (2,101,250 rows) f64, -mat_type dia -ksp_type cg
   -pc_type gamg to rtol 1e-8 on the unpreconditioned residual (the
   preconditioned norm's 1e-8 leaves a true residual near 1e-5 at this
   size), counting B3 and B5 launches: hierarchy, setup and solve times,
   true residual, B3 on every DIA level operator and B5 on every ELL level
   operator against their plain versions, and the same hierarchy solved
   with plain matvecs.
9. Block-DIA, 1025^2 f32, CG + Jacobi to rtol 1e-5, counting B4 launches.
10. The main path with a gamg inner solve: 257^2 f64 saddle route with
    -fieldsplit_inner_pc_type gamg to rtol 1e-8, B1 and B3 both launched.
11. Kernels B2, B5 and B6 against their plain versions, f32 and f64: B2
    for k = 1, 3, 8 fields on grids 4x4 to 1025x1025 with assembled and
    random planes, each field also against B1 on it; B5 on every ELL level
    of phase 8's hierarchy and on random ELL (widths 1-64, padding slots,
    n = 1000 and 100003); B6 on phase 8's 1025^2 DIA operator and on
    random bands (offsets unsorted, gaps wider than a tile's rows,
    offsets beyond the rows; n = 1, 31, 1000, 100003) for k = 1, 4, 8, 9,
    16, 17, X row-major and the transpose of a (k, n) batch, bit-equal to
    its plain version and to B3 column by column through the path the
    wrapper picks, and to its plain version through each of its paths
    (strided, rows, blocked) that applies. Then each timed at 1025^2
    beside its library call (B2 and B6 at k = 8, B6 in both layouts, B5 on
    level 1 of the hierarchy), and B5 against B3 on level 0 stored both
    ways.
12. KSPMatSolve on the stencil, counting B2 launches: 1025^2 f32, k = 8
    right-hand sides f (1 + 0.1 i), CG + Jacobi to rtol 1e-5, per-column
    true residuals; 257^2 f64, k = 4, rtol 1e-8, each column against a
    single-right-hand-side CG (kernel B1) of that column.
13. KSPMatSolve on phase 8's 1025^2 DIA operator, f64, k = 4, CG + gamg
    to rtol 1e-10, counting B6, B3 and B5 launches; per-column true
    residuals.
14. KSPMatSolve on phase 8's 1025^2 DIA operator in f32, k = 8, CG +
    Jacobi to rtol 1e-5: B6 once per iteration; ms per iteration, B6's
    share of the solve, true residuals against a single-right-hand-side
    CG of column 0.
15. Geometric multigrid at 1025^2 f32 (mg_pc, Chebyshev smoother): setup
    seconds and levels (eight, down to 5x5 nodes); each level's Galerkin
    planes against a CPU f64 build from the same planes; B1 against its
    plain version at every level's grid (1025^2 down to 5^2); one V-cycle
    against the same V-cycle built and applied on the CPU; B1 launches and
    host milliseconds per V-cycle.
16. The saddle CLI at 1025^2 f32 to rtol 1e-5 with FGMRES and a Schur
    fieldsplit whose A-block solve is that MG V-cycle, with the upper
    factorization (must converge) and the full one (the JAX bench's, which
    f32 breaks at this size; capped at 200 iterations): iterations,
    PCSetUp and KSPSolve seconds, ms per iteration, the true residual in
    f64, beside phase 5's MINRES + Jacobi at the same size.
17. Mixed-precision refinement (solve_refined_kkt_fused with the JAX
    bench's FGMRES-MG inner: rtol 1e-3, maxiter 60, restart 30; full and
    upper Schur factorizations) to rtol 1e-8 at 257^2 and 1025^2: f64
    residuals through B1 in f64, f32 inner solves through B1 in f32;
    cycles, inner iterations, seconds, the f64 true relative residual
    (plain matvec, <= 1e-8 except the full factorization at 1025^2, which
    f32 breaks: three cycles of it), beside phase 4's direct f64 MINRES at
    257^2 and a direct f64 FGMRES with the same Schur(upper, MG) PC at
    both sizes.
18. The new PC and KSP types through the CLI, each converging with B1 (B3
    on -mat_type dia) launched: at 257^2 f64 Poisson, CG with -pc_type
    pbjacobi, sor, bjacobi, chebyshev, fieldsplit and mg; bcgs, chebyshev
    and richardson (-ksp_max_it 20) with mg; bcgs on -mat_type dia. Then
    BASELINE config 1 (65^2 nodes, MINRES, Schur with a block-Jacobi
    A-block) and config 3's solver (257^2, FGMRES, Schur with an inner CG
    + MG A-block solve), f64 to rtol 1e-8.
19. ILU(0) on the card. The native host library must have loaded. At
    257^2 f64: stencil_ilu0's factors (Lp, Up, invd) built from the
    card's planes against the same from CPU planes, one apply on the card
    against the CPU in f64 and f32 with exactly 12 B1 launches (6 sweeps);
    the CLI to rtol 1e-8 with CG + ILU on the stencil and on -mat_type
    aij (iterations against each other and against the CPU's run of the
    same command), GMRES + ILU, and the saddle route with FGMRES +
    Schur(upper, ILU); a CG + ILU solve stopped at rtol 1e-4, saved
    through the host (utils/checkpoint.py), loaded back onto the card and
    resumed to 1e-8 in fewer iterations than the cold solve. At 65^2 f64
    the CSR's exact level-scheduled solves (-pc_ilu_sweeps 0) against the
    CPU and CG + ILU(exact) through the CLI. At 1025^2 f32 GMRES + ILU
    (-ksp_max_it 3000) on the stencil: iterations, reason, PCSetUp (the
    host factorization) and KSPSolve seconds, B1 launches per iteration
    and the f64 true residual beside phase 9's CG + Jacobi; it must end
    in neither NaN nor DIVERGED_DTOL.
20. The distributed stencil path in a world of one on NCCL (a FileStore
    in a temporary directory; the group is destroyed at the end):
    (d) at 704^2 f32, halo_exchange_1phase, halo_exchange and halo_add on
    the card against zero padding and cropping, the distributed assembly
    (kernel FE) against the serial one (batched products) to 4 ulp of the
    largest entry, and both matvec forms (the operator's overlap
    form, one field through `matmat_field`'s padded form) against the
    serial B1 with exactly one launch of B1's local or padded entry, timed
    beside the serial matvec; (a) BASELINE config 4 through the CLI:
    -problem_type saddle -dist at 704^2 nodes (991,236 rows) f32 to rtol
    1e-5, MINRES + Schur(diag) with the per-patch block-Jacobi A-block (4
    Chebyshev iterations): iterations, reason, Assembly, PCSetUp and
    KSPSolve seconds, ms per iteration, B1 launches per iteration by entry,
    the f64 true relative residual; (b) the serial route at the same size
    with the PC a 1 x 1 mesh reduces to (Chebyshev, -pc_chebyshev_esteig,
    4 iterations): the iteration count within 1 and x within 5e-5
    relative by norm (the routes' assemblies differ by rounding: kernel FE
    against the batched products; f32 MINRES to rtol 1e-5 carries it into
    x, 438 against 437 its and 3.777e-5 on an H100), and
    the ratio of ms per iteration (the cost of the distributed machinery
    at world size 1; the routes run dist, serial, serial, dist and each
    keeps its faster run); (c) GMRES at 257^2 f64 with -dist -pc_type bjacobi
    -sub_pc_type ilu against the serial -pc_type ilu: the same count.
    Multi-rank NCCL exchange needs more than one card and is not run.
21. MATMPIAIJ (parallel/dist_csr.py) in a world of one on NCCL (its own
    FileStore and group, destroyed at the end), on the 704^2 Q1 operator
    (BASELINE config 4's grid, 991,232 rows) in f32: the DistAIJ with its
    banded copy (dia="auto", B3) and without (dia="off", B5), each matvec
    against the serial CSR matvec with exactly one launch, each kernel
    launch against its plain version on the same inputs (bit-equal), the
    matvecs timed beside the serial DIA's; the per-rank ILU(0) on the card
    against the CPU build of the same factors, 2 x 6 B5 launches an apply;
    matmat at k = 8 (one B6 launch, row-major and KSPMatSolve's transposed
    batch) against 8 column matvecs; exchange_triplets and
    dist_aij_from_coo on the card (257^2 f64, duplicated and shuffled
    triplets) against dist_aij_from_scipy; then the CLI: -mat_type aij
    -dist with CG + Jacobi and CG + bjacobi (per-rank ILU(0), 6 sweeps) to
    rtol 1e-5, beside the serial -mat_type aij route with the PC a world of
    one reduces to (Jacobi; -pc_type ilu, 6 CSR sweeps), run dist, serial,
    serial, dist: iterations, reason, Assembly, PCSetUp and KSPSolve
    seconds, ms per iteration, B3/B5/B6 launches per iteration and the f64
    true residual.
22. The distributed gamg (solvers/amg.py's dist_amg_pc) in a world of one
    on NCCL (its own FileStore and group, destroyed at the end): (a) the
    JAX bench's gamg_* workload (bench.py:895-939), the 1024^2 5-point
    Poisson (1,048,576 rows) in f32, CG to rtol 1e-6 under the streaming
    and the global setup: iterations, reason, PCSetUp and KSPSolve
    seconds, the levels (rows, banded B3 or ELL B5 and its width), B3 and
    B5 launches per iteration, the f64 true residual; (b) the CLI at 704^2
    f64 (the Q1 operator, 991,232 rows), -mat_type aij -dist -pc_type gamg
    with -pc_gamg_setup global and stream beside the serial -mat_type aij
    -pc_type gamg, CG to rtol 1e-8 on the unpreconditioned norm, run dist,
    serial, serial, dist: the f64 true residual at most 1e-6, the global
    count within 1 of the serial one and the stream count within 1 of the
    global one (the coarsest level passes the 4096-row cap:
    SplitCoarseInverse); (c) one DistAMGPC apply at 1024^2 f64: exactly
    six B3 or B5 launches a level and two B5, its device time, and its
    result against the same hierarchy built on a CPU mesh; (d)
    graft_entry.dryrun_multichip() and entry() on the card.
23. The distributed SOR, fieldsplit and geometric MG (precond.sor and
    dist_fieldsplit on a DistStencilOperator, multigrid.mg_pc_dist) in a
    world of one on NCCL (its own FileStore and group, destroyed at the
    end), each -dist CLI run beside the serial one, run dist, serial,
    serial, dist: (a) 1025^2 Poisson f64, CG + -pc_type mg to rtol 1e-8:
    equal counts, |x_dist - x_serial| / |x_serial| at most 1e-12, the
    levels, one V-cycle's B1 launches by entry, its time and its result
    against the serial V-cycle; (b) 257^2 f64, CG + -pc_type sor and
    GMRES + -pc_type fieldsplit -pc_fieldsplit_type multiplicative: equal
    counts; (c) the 1025^2 f64 saddle, MINRES + Schur(diag) with
    -fieldsplit_inner_pc_type mg -pc_mg_smoother chebyshev: equal counts;
    (d) BASELINE config 5's solver at 2241^2 nodes (10,044,166 KKT rows)
    in f64 through the CLI: iterations, reason, Assembly / PCSetUp /
    KSPSolve seconds, ms an iteration, the levels (2241 -> ... -> 71 split,
    the 36^2 coarsest gathered, 2592 dofs), B1 launches per iteration,
    exactly one FE launch (one rank, one assembly), the f64 true residual
    and the peak device memory; then B1 against its plain version at
    every level's grid of (d).
24. The JAX bench's distributed mixed-precision refinement
    (`bench_refined_kkt_dist`, bench.py:407-583) in a world of one on NCCL
    (its own FileStore and group, destroyed at the end): the trig KKT
    system assembled in f64 by `assemble_saddle_dist`, its f32 copy for
    the inner operator and PC (built once), `solve_refined_kkt_fused` to
    rtol 1e-8 with inner rtol 1e-3 and the f64 residual through the
    distributed f64 operator. (a) The bench's kkt_rtol1e8_dist setting:
    705^2 nodes (994,054 KKT rows), MINRES + Schur(diag) inner, at most
    6000 inner iterations, beside the serial refinement of the same arrays
    (equal cycles and inner iterations, x bit-equal); (b) config 5: 2241^2
    (10,044,166 rows), MINRES + Schur(diag, distributed MG, Chebyshev)
    inner, at most 20000, beside phase 23 (d)'s direct f64 MINRES. Each
    run prints cycles, inner iterations, reason, Assembly, PCSetUp and
    solve seconds, B1 launches in f32 (inner) and f64 (residual), exactly
    one FE launch for its assembly, the peak device memory and the f64
    true relative residual (at most 1e-8),
    recomputed with the plain serial matvec on the gathered patch; then B1
    against its plain version in both types at its grid.
25. The bench twin, `python -m saddle_point_petsc_tpu_torch.bench`, in a
    subprocess at its full sizes, with BENCH_DEADLINE_S what is left of
    the script's 1200 s: it must exit 0 and print a last line of JSON of
    at most 1900 bytes with no errors key and no deadline hit, every key
    group (spmv, kkt_solve, kkt_rtol1e8, kkt_rtol1e8_dist, aij_tpu, gamg,
    config2/3/4, config3_rtol1e8, scaling, config5, spmm; read from its
    full dict), `device` and `scaling_backend` on the line itself,
    vs_baseline at most 1.05 of the bandwidth its own copy
    measured, refined relative residuals at most 1e-8, and the counts of
    this run's phases: config4_iterations (phase 20's -dist route),
    gamg_its (phase 22 (a), stream) and the cycles and inner iterations of
    kkt_rtol1e8_dist (phase 24 (a)) and config5 (phase 24 (b)). The line
    is printed on a line of its own.
26. (Run after phase 3.) Kernel FE, one rank's Q1 assembly
    (csrc/q1_assembly.cu), on a world of one's patch of BASELINE config 5
    (2241^2 f64) and config 4 (704^2 f32), trig load and constraint rows:
    one launch, counted by type; planes, load and rows against the plain
    version (parallel/dist.py's batched products of models/fem.py, on the
    card): in f64 the planes to 1e-12, load and rows to 1e-12 of their
    largest entry; in f32 4 ulp of the largest entry; then
    timed (median of 60 launches; the plain version, ~1 s a call at 2241^2,
    median of 5) beside its bound (46 values written a padded node), and
    the peak device memory of one call of each.

Each kernel's timing runs in the order plain, kernel, library, library,
kernel, plain (medians of 60 launches each) and prints the kernel's
bound: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its operations over the type's peak rate. The
library call is the one PyTorch call computing the same function:
`A_csr @ x` (`@ X`, row-major, for B2 and B6) with A_csr a
torch.sparse_csr_tensor with int32 indices of the same matrix; it is
checked once against the kernel (up to rounding, after reordering) and
never called by the port.

The last lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}. A kernel's row in the kernels JSON counts
the launches of the main-path runs of this script (for FE, the -dist
assemblies of phases 23 (d) and 24), each counted by the program.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from saddle_point_petsc_tpu_torch import cli, graft_entry
from saddle_point_petsc_tpu_torch.models import poisson
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.cuda import _build, assembly, bdia, dia, dia_spmm, ell, rng, spmm, spmv
from saddle_point_petsc_tpu_torch.models import saddle
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator, field_to_flat
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import dist_csr
from saddle_point_petsc_tpu_torch.parallel import halo
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.solvers import amg, ilu_stencil, krylov, multigrid, precond, refine
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.tools import dist_probe
from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator
from saddle_point_petsc_tpu_torch.utils import checkpoint, monitor, native
from saddle_point_petsc_tpu_torch.utils.options import Options

# (nx, ny) nodes: ragged small grids up to 1025^2, the main path's 256^2 and 257^2 among them
GRIDS = ((4, 4), (7, 5), (33, 17), (257, 129), (256, 256), (257, 257), (1025, 1025))
# node grids of the assembled DIA and block-DIA operators checked in phase 6
SPARSE_GRIDS = ((4, 4), (7, 5), (33, 17), (257, 257), (1025, 1025))
N_TIMED = 1025  # node grid side at which the kernels are timed (phases 3, 6, 11)
# B1 and B2: the kernel and its plain version sum the same 36 products in
# the same order; only FMA contraction differs, so they agree to a few ulps
# of max|y|. B3, B4, B5 and B6 round each product and sum as the plain
# versions do and are held to the same bounds (expected: equal bits).
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the kernels whose launches the program counts in monitor.counters
# ("<kernel>.launches"), and B1's counters by entry point
KERNELS = ("B1", "B2", "B3", "B4", "B5", "B6", "FE")
B1_ENTRIES = {"stencil_spmv": "B1.launches.local", "stencil_spmv_padded": "B1.launches.padded"}
BENCH_R04_KKT_ITERATIONS = 452  # BENCH_r04.json kkt_iterations (256^2, f32, rtol 1e-5)
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bandwidth, and the arithmetic rate outside the tensor cores of the
# type a kernel computes in. A kernel's bound is the larger of its bytes
# (each input read once, each output written once) over the first and its
# operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# B6 cases of phase 11 beside the 1025^2 operator: offsets unsorted, with
# gaps wider than a tile's rows and beyond the rows, as (offsets, row counts)
B6_OFFSETS = (
    ((-300, -17, -1, 0, 3, 129, 255), (1, 31, 1000, 100003)),
    ((3, -5000, 0, 5000, 1, -64, 64, -2, 2, -3), (31, 100003)),
)
B6_COLUMNS = (1, 4, 8, 9, 16, 17)


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


def _bound(nbytes, flops, dtype):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move nbytes and do flops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_csr(a, dtype, dev):
    """The yardstick of a kernel: scipy matrix `a` as a torch.sparse_csr_tensor
    with int32 indices on the card, explicit zeros dropped, for the one
    PyTorch call `A_csr @ x` (or `@ X`) that computes the kernel's function.
    Timed here only; the port never calls it."""
    a = a.tocsr()
    a.eliminate_zeros()
    a.sort_indices()
    return torch.sparse_csr_tensor(
        torch.tensor(a.indptr, dtype=torch.int32, device=dev),
        torch.tensor(a.indices, dtype=torch.int32, device=dev),
        torch.tensor(a.data, dtype=dtype, device=dev),
        a.shape,
    )


def _timed(name, label, card, dtype, nbytes, flops, plain, kernel, library):
    """Median device times in the order plain, kernel, library, library,
    kernel, plain; prints them beside the bound and returns the row's
    numbers, each time the better of its two medians."""
    ts = [_median_ms(f) for f in (plain, kernel, library, library, kernel, plain)]
    out = {"ms": min(ts[1], ts[4]), "plain_ms": min(ts[0], ts[5]), "library_ms": min(ts[2], ts[3])}
    out["bound_ms"], out["bound_by"] = _bound(nbytes, flops, dtype)
    for what in ("ms", "plain_ms", "library_ms"):
        t = out[what]
        print(f"{name:<3} time {label} {what[:-3] or 'kernel':<7} {t * 1e3:9.2f} us "
              f"{nbytes / t / 1e6:8.1f} GB/s  ({card})")
    print(
        f"  bound {out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP); kernel at {out['bound_ms'] / out['ms']:.2f} of it, "
        f"library/kernel {out['library_ms'] / out['ms']:.2f}; medians of 60 in turn (plain, "
        f"kernel, library, library, kernel, plain): {' '.join(f'{t * 1e3:.2f}' for t in ts)} us"
    )
    return out


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
    nx = ny = N_TIMED
    for dtype in (torch.float32, torch.float64):
        A = poisson.assemble_poisson(nx - 1, ny - 1, dtype=dtype, device=dev, body_force="trig").A
        planes = A.planes
        x = torch.randn((2, ny, nx), generator=gen, dtype=dtype, device=dev)
        # the library call takes the natural interleaved ordering (field_to_flat)
        A_csr, x_flat = _library_csr(amg._to_scipy(A), dtype, dev), field_to_flat(x).contiguous()
        _compare("B1 library call against the kernel", A_csr @ x_flat,
                 field_to_flat(spmv.stencil_spmv(planes, x)), dtype)
        timings[dtype] = _timed(
            "B1", f"{str(dtype)[6:]:<8} {nx}x{ny}", card, dtype, 40 * planes.element_size() * ny * nx,
            72 * ny * nx, lambda: spmv.planes_matvec_field(planes, x), lambda: spmv.stencil_spmv(planes, x),
            lambda: A_csr @ x_flat)
        del A_csr
    return max_err, timings


# kernel RN (phase 3): draws of odd sizes and one seed above 32 bits, then
# the start vectors of config 5's six Chebyshev levels (2 dof a node, f64)
RN_DRAWS = ((1, 0, 0), (7, 5, 1), (1001, (1 << 40) + 3, 2), (2 * 71 * 71 + 1, 2**31 + 7, 0),
            (2 * 2241 * 2241, 0, 0))
RN_LEVELS = (2241, 1121, 561, 281, 141, 71)


def phase_rn(dev, card):
    """Phase 3, kernel RN (the normal draws of estimate_lmax's start
    vector) against its CPU twin: the Philox words bit-equal, the normals
    within 4 ulp, in f32 and f64, one launch a draw; then the six draws of
    config 5's Chebyshev levels (13.4M f64 values, 107 MB written) timed
    with CUDA events beside their store bound and torch's own CUDA
    normal_ (the yardstick, never called by the port), and on the host
    clock the twin and what the port did before: torch.randn on the CPU
    and a pageable copy to the card. Returns (the largest ulp distance,
    the timings row)."""
    max_ulp = 0.0
    for dtype in (torch.float32, torch.float64):
        for n, seed, leaf in RN_DRAWS:
            pairs = (n + 1) // 2
            words = rng.philox_words(pairs, seed, leaf, device=dev)
            _reset_counts()
            z = rng.normal_(torch.empty(n, dtype=dtype, device=dev), seed, leaf)
            torch.cuda.synchronize()
            launches = (_launches("RN"), monitor.counters.get(f"RN.launches.{str(dtype)[6:]}"))
            same_bits = np.array_equal(words.cpu().numpy().view(np.uint32), rng.philox_words_plain(pairs, seed, leaf))
            want = rng.normal_plain(n, seed, leaf).astype(str(dtype)[6:])
            ulp = float((np.abs(z.cpu().numpy() - want) / np.spacing(np.abs(want))).max())
            ok = same_bits and ulp <= 4 and launches == (1, 1)
            print(f"RN {str(dtype)[6:]:<8} n={n:<9} seed={seed:<14} leaf={leaf} words "
                  f"{'bit-equal' if same_bits else 'DIFFER'}, normals max {ulp:.2f} ulp, launches {launches} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel RN disagrees with its twin: n={n} {dtype}")
            max_ulp = max(max_ulp, ulp)
            del words, z

    outs = [torch.empty((2, n, n), dtype=torch.float64, device=dev) for n in RN_LEVELS]
    nbytes = sum(o.numel() for o in outs) * 8

    def kernel():
        for o in outs:
            rng.normal_(o)

    def library():
        for o in outs:
            o.normal_()

    ts = [_median_ms(kernel), _median_ms(library), _median_ms(library), _median_ms(kernel)]
    row = {"ms": min(ts[0], ts[3]), "library_ms": min(ts[1], ts[2])}
    row["bound_ms"], row["bound_by"] = _bound(nbytes, 0, torch.float64)
    t0 = time.perf_counter()
    for n in RN_LEVELS:
        rng.normal_plain(2 * n * n)
    row["plain_ms"] = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    for o in outs:
        o.copy_(torch.randn(o.shape, generator=gen, dtype=o.dtype))
    torch.cuda.synchronize()
    row["host_randn_copy_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"RN  time f64 config 5's six levels ({nbytes / 8:.0f} values) kernel {row['ms'] * 1e3:9.2f} us "
          f"{nbytes / row['ms'] / 1e6:8.1f} GB/s ({card})")
    print(f"  bound {row['bound_ms'] * 1e3:.2f} us (bytes: {nbytes / 1e6:.1f} MB written); kernel at "
          f"{row['bound_ms'] / row['ms']:.2f} of it, torch normal_ on the card {row['library_ms'] * 1e3:.2f} us; "
          f"medians of 60 in turn (kernel, library, library, kernel): {' '.join(f'{t * 1e3:.2f}' for t in ts)} us; "
          f"host clock: the twin {row['plain_ms']:.1f} ms, CPU torch.randn + copy to the card "
          f"{row['host_randn_copy_ms']:.1f} ms")
    del outs
    return max_ulp, row


# kernel FE (phase 26): BASELINE config 5's grid in f64 and config 4's in
# f32, as one rank's patch
FE_GRIDS = ((2241, torch.float64), (704, torch.float32))
# what it writes a padded node: 36 plane entries, 2 loads, 8 constraint-row entries
FE_OUTPUTS = 46
# operations an element needs once (the kernel forms each element again
# for each of its 4 corners, which this does not count): at each of 4 Gauss
# points the shape functions and gradients, the Jacobian, its inverse and
# the physical gradients (~160), the whole 8x8 stiffness (~190), the load
# and the 4 constraint integrals (~20); then 64 + 8 + 16 sums onto the nodes
FE_FLOPS_PER_ELEMENT = 4 * (160 + 190 + 20) + 88


def _fe_tol(want, dtype, label="planes"):
    """Kernel FE against the batched products, which sum in another order:
    in f64 1e-12 absolute for the planes (entries of order 1), 1e-12 of
    max|want| for loads and constraint rows (entries of order h^2); 4 ulp
    of max|want| in f32."""
    scale = want.abs().max().item()
    if dtype == torch.float64:
        return 1e-12 if label == "planes" else 1e-12 * scale
    return 4 * torch.finfo(dtype).eps * scale


def _fe_peak(fn, dev):
    """Peak device bytes allocated by one call of fn, beyond what was held."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del out
    return peak


def phase_fe(dev, card):
    """Phase 26 (run after phase 3): kernel FE, one rank's Q1 assembly, on
    a world of one's patch of BASELINE config 5 (2241^2 f64) and config 4
    (704^2 f32) with the trig load and the constraint rows: one launch,
    each accumulator against the plain version (the batched products on
    the card; in f64 planes to 1e-12, load and rows to 1e-12 of their
    largest entry; 4 ulp of the largest entry in f32), then the kernel timed (median of 60, CUDA
    events) beside its bound and the plain version (median of 5, ~1 s a
    call at 2241^2), and the peak device memory of one call of each.
    Returns (the largest f64 error, {dtype: timings})."""
    out, max_err = {}, 0.0
    for n, dtype in FE_GRIDS:
        grid = pdist.DistGrid.create(n - 1, n - 1, types.SimpleNamespace(py=1, px=1, pj=0, pi=0))
        xs, ys = pdist._local_axes(grid, dtype, dev)
        my, mx = grid.my, grid.mx
        _reset_counts()
        got = assembly.q1_assemble(xs, ys, my, mx, force="trig", rows=True)
        torch.cuda.synchronize()
        if _launches("FE") != 1 or monitor.counters.get(f"FE.launches.{str(dtype)[6:]}") != 1:
            raise AssertionError(f"kernel FE at {n}^2: launches {monitor.counters}")
        for i, label in enumerate(("planes", "load", "rows")):
            # one plain accumulator at a time: at 2241^2 the batched
            # products of the planes alone hold ~12.5 GB
            want = pdist._accumulators_plain(xs, ys, my, mx, body_force="trig" if i == 1 else None,
                                             planes=i == 0, rows=i == 2)[i]
            err, scale, tol = (got[i] - want).abs().max().item(), want.abs().max().item(), _fe_tol(want, dtype, label)
            print(f"FE {str(dtype)[6:]:<8} {n}^2 {label:<6} max|d|={err:.3e} max|ref|={scale:.3e} tol={tol:.3e} "
                  f"{'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                raise AssertionError(f"kernel FE disagrees with its plain version: {n}^2 {dtype} {label}")
            if dtype == torch.float64:
                max_err = max(max_err, err)
            del want
        del got
        item = torch.finfo(dtype).bits // 8
        nbytes = (FE_OUTPUTS * (my + 2) * (mx + 2) + xs.numel() + ys.numel()) * item
        flops = FE_FLOPS_PER_ELEMENT * (n - 1) ** 2

        def kernel():
            return assembly.q1_assemble(xs, ys, my, mx, force="trig", rows=True)

        def plain():
            return pdist._accumulators_plain(xs, ys, my, mx, body_force="trig", rows=True)

        ts = [_median_ms(plain, n=5, warmup=1), _median_ms(kernel), _median_ms(kernel), _median_ms(plain, n=5, warmup=1)]
        row = {"ms": min(ts[1], ts[2]), "plain_ms": min(ts[0], ts[3])}
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dtype)
        peaks = _fe_peak(kernel, dev), _fe_peak(plain, dev)
        print(f"FE  time {str(dtype)[6:]:<8} {n}x{n} kernel {row['ms'] * 1e3:9.2f} us "
              f"{nbytes / row['ms'] / 1e6:8.1f} GB/s, plain {row['plain_ms'] * 1e3:.2f} us ({card})")
        print(f"  bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {nbytes / 1e6:.1f} MB written, "
              f"{flops / 1e9:.3f} GFLOP); kernel at {row['bound_ms'] / row['ms']:.2f} of it, plain/kernel "
              f"{row['plain_ms'] / row['ms']:.1f}; medians in turn (plain of 5, kernel of 60, kernel, plain): "
              f"{' '.join(f'{t * 1e3:.2f}' for t in ts)} us; peak device memory of a call: kernel "
              f"{peaks[0]} B, plain {peaks[1]} B")
        out[dtype] = row
    return max_err, out


def _reset_counts():
    monitor.reset_counters()


def _launches(kernel):
    return monitor.counters.get(f"{kernel}.launches", 0)


def _counts():
    return {name: _launches(name) for name in KERNELS}


def _entry_launches():
    """B1's launches since the last reset, by entry point."""
    return {entry: monitor.counters.get(key, 0) for entry, key in B1_ENTRIES.items()}


def _dtype_launches():
    """B1's launches since the last reset, by type."""
    return {t: monitor.counters.get(f"B1.launches.{str(t)[6:]}", 0) for t in (torch.float32, torch.float64)}


def _cli(argv, kernels=("B1",)):
    """One in-process CLI run with every kernel count set to 0 just before;
    returns (CliRun, {name: launches during it}). Each named kernel must
    have launched at least once per iteration."""
    print("$ python -m saddle_point_petsc_tpu_torch.cli " + " ".join(argv), flush=True)
    _reset_counts()
    run = cli.run(argv)
    counts = _counts()
    res = run.result
    print(
        f"launches {' '.join(f'{k} {v}' for k, v in counts.items())}, "
        f"iterations {res.iterations}, reason {res.reason_name()}"
    )
    if run.rc != 0 or res.reason_name() != "CONVERGED_RTOL":
        raise AssertionError(f"CLI run did not converge: rc={run.rc} {res.reason_name()}")
    for name in kernels:
        if counts[name] < res.iterations:
            raise AssertionError(f"{name} launched {counts[name]} times for {res.iterations} iterations")
    return run, counts


def phase_f64(tmp):
    vtk_path = os.path.join(tmp, "saddle_257.vtk")
    run, counts = _cli([
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
    return counts["B1"], {"its": res.iterations, "solve_s": t_solve}


def phase_f32(tmp):
    out = {}
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
        out[n] = {"its": its, "solve_s": t, "true_rel": dist_probe.true_rel_kkt(
            run.problem.A.planes.double(), run.problem.Bf.double(), run.problem.rhs, run.result.x)}
        if n == 256:
            print(f"256^2 f32 iterations {its} beside {BENCH_R04_KKT_ITERATIONS} in BENCH_r04.json")
            if abs(its - BENCH_R04_KKT_ITERATIONS) > 0.2 * BENCH_R04_KKT_ITERATIONS:
                raise AssertionError(f"{its} iterations, not within 20% of {BENCH_R04_KKT_ITERATIONS}")
    return out


def _compare(label, got, ref, dtype, quiet=False):
    """|got - ref| <= TOL * max|ref|, printed unless quiet; returns the max
    abs error."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1e-300)
    ok = err <= TOL[dtype] * scale
    if not quiet or not ok:
        print(
            f"{label} {str(dtype)[6:]:<8} max|dy|={err:.3e} max|y|={scale:.3e} "
            f"rel={err / scale:.3e} tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}"
        )
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version ({dtype})")
    return err


def _check_dia(label, data, x, offsets, dtype):
    """B3 through both entry names against dia_spmv_plain."""
    ref = dia.dia_spmv_plain(data, x, offsets)
    return max(
        _compare(f"B3  {label:<36}", dia.dia_spmv_2d(data, x, offsets), ref, dtype),
        _compare(f"B3' {label:<36}", dia.dia_spmv(data, x, offsets), ref, dtype),
    )


def _check_ell(label, cols_t, vals_t, x, dtype):
    ref = ell.ell_spmv_plain(cols_t, vals_t, x)
    return _compare(f"B5  {label:<36}", ell.ell_spmv(cols_t, vals_t, x), ref, dtype)


def _check_bdia(label, data, xb, offsets, active, dtype):
    ref = bdia.bdia_spmv_plain(data, xb, offsets, active)
    return _compare(f"B4  {label:<36}", bdia.bdia_spmv_2d(data, xb, offsets, active), ref, dtype)


def phase_sparse_kernels(dev, card):
    """Phase 6: B3, B3' and B4 against their plain versions, then timed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rnd = random.Random(1)
    err = {"B3": 0.0, "B4": 0.0}
    big = None
    for nx, ny in SPARSE_GRIDS:
        t0 = time.perf_counter()
        csr, _, _, _ = poisson.assemble_poisson_csr(nx - 1, ny - 1, dtype=torch.float64, device=dev)
        A, _ = sparse.csr_to_dia(csr)
        B = sparse.bsr_to_bdia(sparse.csr_to_bsr(csr, 2))
        del csr
        print(
            f"{nx}x{ny}: {A.shape[0]} rows, DIA offsets {len(A.offsets)}, block-DIA "
            f"offsets {len(B.offsets)} active {len(B.active)}; assembled and "
            f"converted in {time.perf_counter() - t0:.2f} s"
        )
        for dtype in (torch.float32, torch.float64):
            data, bdata = A.data.to(dtype), B.data.to(dtype)
            x = torch.randn((A.shape[0],), generator=gen, dtype=dtype, device=dev)
            err["B3"] = max(err["B3"], _check_dia(f"{nx}x{ny} assembled", data, x, A.offsets, dtype))
            xb = x.reshape(-1, 2).T.contiguous()
            err["B4"] = max(err["B4"], _check_bdia(
                f"{nx}x{ny} assembled", bdata, xb, B.offsets, B.active, dtype))
        if (nx, ny) == SPARSE_GRIDS[-1]:
            big = A, B
    for dtype in (torch.float32, torch.float64):
        offs = (-300, -17, -1, 0, 3, 129, 255)
        for n in (1000, 100003):
            data = torch.randn((len(offs), n), generator=gen, dtype=dtype, device=dev)
            x = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
            err["B3"] = max(err["B3"], _check_dia(f"random n={n}", data, x, offs, dtype))
        boffs = (-40, -3, 0, 1, 7, 300)
        for b in (1, 2, 3):
            for mb in (777, 50001):
                triples = [(k, c, d) for k in range(len(boffs)) for c in range(b) for d in range(b)]
                active = tuple(t for t in triples if rnd.random() < 0.6) or (triples[0],)
                data = torch.randn((len(boffs), b, b, mb), generator=gen, dtype=dtype, device=dev)
                xb = torch.randn((b, mb), generator=gen, dtype=dtype, device=dev)
                err["B4"] = max(err["B4"], _check_bdia(
                    f"random b={b} mb={mb} |active|={len(active)}", data, xb, boffs, active, dtype))

    A, B = big
    csr_a, csr_b = sparse.to_scipy(A), sparse.to_scipy(B)  # the same matrix twice, f64
    timings = {}
    for dtype in (torch.float32, torch.float64):
        data, bdata = A.data.to(dtype), B.data.to(dtype)
        n, nd = A.shape[0], len(A.offsets)
        x = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
        xb = x.reshape(-1, 2).T.contiguous()  # block-DIA's dof-major layout of x
        mb, na = xb.shape[1], len(B.active)
        es = x.element_size()
        lib_a, lib_b = _library_csr(csr_a, dtype, dev), _library_csr(csr_b, dtype, dev)
        _compare("B3 library call against the kernel", lib_a @ x, dia.dia_spmv_2d(data, x, A.offsets), dtype)
        _compare("B4 library call against the kernel", lib_b @ x,
                 bdia.bdia_spmv_2d(bdata, xb, B.offsets, B.active).T.reshape(-1), dtype)
        for name, plain, kernel, library, nbytes, flops in (
            ("B3", lambda: dia.dia_spmv_plain(data, x, A.offsets),
             lambda: dia.dia_spmv_2d(data, x, A.offsets), lambda: lib_a @ x, (nd + 2) * n * es, 2 * nd * n),
            ("B3'", lambda: dia.dia_spmv_plain(data, x, A.offsets),
             lambda: dia.dia_spmv(data, x, A.offsets), lambda: lib_a @ x, (nd + 2) * n * es, 2 * nd * n),
            ("B4", lambda: bdia.bdia_spmv_plain(bdata, xb, B.offsets, B.active),
             lambda: bdia.bdia_spmv_2d(bdata, xb, B.offsets, B.active), lambda: lib_b @ x,
             (na + 4) * mb * es, 2 * na * mb),
        ):
            timings[name, dtype] = _timed(name, f"{str(dtype)[6:]:<8} {n} rows", card, dtype, nbytes,
                                          flops, plain, kernel, library)
        del lib_a, lib_b
    return err, timings


def phase_formats(tmp):
    """Phase 7: -mat_type aij, dia, bdia and the stencil route agree."""
    base = [
        "-device", "cuda", "-dtype", "f64", "-da_grid_x", "257", "-da_grid_y", "257",
        "-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8", "-ksp_converged_reason",
    ]
    its, xs, vtks = {}, {}, {}
    for mat_type, kernels in (("aij", ()), ("dia", ("B3",)), ("bdia", ("B4",)), ("stencil", ("B1",))):
        vtks[mat_type] = os.path.join(tmp, f"poisson_{mat_type}.vtk")
        run, _ = _cli(base + ["-mat_type", mat_type, "-vtk", vtks[mat_type]], kernels)
        its[mat_type] = run.result.iterations
        x = run.result.x
        xs[mat_type] = field_to_flat(x) if x.ndim == 3 else x
    print(f"257^2 f64 CG+Jacobi iterations: {its}")
    if not (its["aij"] == its["dia"] and abs(its["bdia"] - its["aij"]) <= 1
            and abs(its["aij"] - its["stencil"]) <= 2):
        raise AssertionError(f"iteration counts disagree: {its}")
    ref = xs["aij"]
    for mat_type, tol in (("dia", 1e-8), ("bdia", 1e-8), ("stencil", 1e-6)):
        dx = (krylov.tnorm(xs[mat_type] - ref) / krylov.tnorm(ref)).item()
        print(f"|x_{mat_type} - x_aij| / |x_aij| = {dx:.3e} (tol {tol:g})")
        if not dx <= tol:
            raise AssertionError(f"{mat_type} solution differs from aij by {dx}")
    # B3 and B4 sum each row in column order and round as their plain
    # versions do, so dia and bdia give the same bits; the CSR route's
    # row sums (torch.segment_reduce) round otherwise on the card
    with open(vtks["dia"], "rb") as fd, open(vtks["bdia"], "rb") as fb:
        same = fd.read() == fb.read()
    print(f"dia and bdia VTK files byte-identical: {same}")
    if not same:
        raise AssertionError("dia and bdia wrote different VTK files")


@dataclasses.dataclass(frozen=True)
class _PlainDIA:
    """A DIA operator whose matvec is B3's plain version on any device."""

    A: sparse.DIA

    def __call__(self, x):
        return dia.dia_spmv_plain(self.A.data, x.contiguous(), self.A.offsets)

    def diagonal(self):
        return self.A.diagonal()


@dataclasses.dataclass(frozen=True)
class _PlainELL:
    """A gamg ELL level operator whose matvec is B5's plain version on any
    device."""

    A: amg._EllOp

    def __call__(self, x):
        return ell.ell_spmv_plain(self.A.ell.cols_t, self.A.ell.vals_t, x.contiguous())

    def diagonal(self):
        return self.A.diagonal()


def _plain(op):
    if isinstance(op, sparse.DIA):
        return _PlainDIA(op)
    return _PlainELL(op) if isinstance(op, amg._EllOp) else op


def phase_gamg(dev):
    """Phase 8: CG + gamg on the 1025^2 DIA operator, counting B3 and B5."""
    n = 1025
    run, counts = _cli([
        "-device", "cuda", "-dtype", "f64", "-da_grid_x", str(n), "-da_grid_y", str(n),
        "-mat_type", "dia", "-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
        "-ksp_norm_type", "unpreconditioned", "-ksp_converged_reason", "-log_view", "-no_vtk",
    ], ("B3", "B5"))
    prob, res, M = run.problem, run.result, run.ksp.M
    t_setup, t_solve = (run.log.phases[p].total_s for p in ("PCSetUp", "KSPSolve"))
    print(
        f"{n}^2 f64 CG+gamg: {res.iterations} its, PCSetUp {t_setup:.3f} s, KSPSolve "
        f"{t_solve:.4f} s ({t_solve / res.iterations * 1e3:.3f} ms/it), B3 launches {counts['B3']}, "
        f"B5 launches {counts['B5']}, "
        f"aggregation {amg.aggregation_route}"
    )
    for k, lvl in enumerate(M.levels):
        fmt = type(lvl.A).__name__
        offs = f", {len(lvl.A.offsets)} offsets {lvl.A.offsets}" if fmt == "DIA" else ""
        if fmt == "_EllOp":
            offs = f", ELL width {lvl.A.ell.cols_t.shape[0]}"
        print(f"  level {k}: {lvl.agg.shape[0]} rows -> {lvl.n_c}, {fmt}{offs}")
    ci = M.coarse_inv
    split = f" ({ci.iso.shape[0]} decoupled rows + dense {ci.rest.shape[0]})" if hasattr(ci, "iso") else ""
    print(f"  coarse: {ci.shape[0]} rows, {type(ci).__name__}{split}")
    if res.iterations > 30:
        raise AssertionError(f"gamg took {res.iterations} iterations")
    A, b = prob.A, prob.f
    true_rel = (krylov.tnorm(b - _plain(A)(res.x)) / krylov.tnorm(b)).item()
    print(f"true residual |b - Ax|/|b| = {true_rel:.3e} (f64, plain matvec)")
    if not true_rel <= 1e-6:
        raise AssertionError(f"true residual {true_rel} > 1e-6")

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    err = {"B3": 0.0, "B5": 0.0}
    for k, lvl in enumerate(M.levels):
        label = f"gamg level {k}"
        if isinstance(lvl.A, sparse.DIA):
            x = torch.randn((lvl.A.shape[0],), generator=gen, dtype=torch.float64, device=dev)
            err["B3"] = max(err["B3"], _check_dia(f"{label} ({lvl.A.shape[0]} rows)", lvl.A.data, x,
                                                  lvl.A.offsets, torch.float64))
        else:
            E = lvl.A.ell
            x = torch.randn((E.shape[1],), generator=gen, dtype=torch.float64, device=dev)
            err["B5"] = max(err["B5"], _check_ell(f"{label} ({E.shape[0]} rows)", E.cols_t, E.vals_t,
                                                  x, torch.float64))

    levels = tuple(
        dataclasses.replace(
            lvl, A=_plain(lvl.A), smoother=dataclasses.replace(lvl.smoother, A=_plain(lvl.smoother.A))
        )
        for lvl in M.levels
    )
    _reset_counts()
    t0 = time.perf_counter()
    res_p = krylov.cg(_plain(A), b, M=dataclasses.replace(M, levels=levels), rtol=1e-8,
                      maxiter=200, norm_type="unpreconditioned")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    dx = (krylov.tnorm(res.x - res_p.x) / krylov.tnorm(res_p.x)).item()
    print(
        f"same hierarchy, plain DIA and ELL matvecs: {res_p.iterations} its, {t_plain:.4f} s, "
        f"B3 launches {_launches("B3")}, B5 launches {_launches("B5")}; "
        f"|x_kernel - x_plain|/|x_plain| = {dx:.3e}"
    )
    if _launches("B3") or _launches("B5") or res_p.reason_name() != "CONVERGED_RTOL":
        raise AssertionError(
            f"plain solve: {res_p.reason_name()}, {_launches("B3")} B3, {_launches("B5")} B5 launches")
    if abs(res_p.iterations - res.iterations) > 1 or not dx <= 1e-6:
        raise AssertionError(f"plain solve {res_p.iterations} its, dx {dx}")
    return counts, err, run


def phase_bdia_full():
    """Phase 9: block-DIA at 1025^2 f32, CG + Jacobi, counting B4."""
    run, counts = _cli([
        "-device", "cuda", "-dtype", "f32", "-da_grid_x", "1025", "-da_grid_y", "1025",
        "-mat_type", "bdia", "-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-5",
        "-ksp_converged_reason", "-log_view", "-no_vtk",
    ], ("B4",))
    t = run.log.phases["KSPSolve"].total_s
    its = run.result.iterations
    print(f"1025^2 f32 block-DIA CG+Jacobi: {its} its, {t:.4f} s, {t / its * 1e3:.4f} ms/it")
    return counts["B4"], {"its": its, "solve_s": t}


def phase_saddle_gamg():
    """Phase 10: the saddle route with a gamg inner solve, B1 and B3."""
    run, counts = _cli([
        "-device", "cuda", "-dtype", "f64", "-problem_type", "saddle", "-body_force", "trig",
        "-da_grid_x", "257", "-da_grid_y", "257", "-fieldsplit_inner_pc_type", "gamg",
        "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-log_view", "-no_vtk",
    ], ("B1", "B3"))
    prob, res = run.problem, run.result
    true_rel = (krylov.tnorm(krylov.tsub(prob.rhs, prob.K(res.x))) / krylov.tnorm(prob.rhs)).item()
    t = run.log.phases["KSPSolve"].total_s
    print(
        f"257^2 f64 MINRES + Schur(gamg): {res.iterations} its, {t:.4f} s; "
        f"true residual {true_rel:.3e}"
    )
    if not true_rel <= 1e-6:
        raise AssertionError(f"true residual {true_rel} > 1e-6")


def _field_rows(XT):
    """(k, 2, ny, nx) fields -> the row-major (n, k) X whose column j is
    field_to_flat(XT[j]) (the natural interleaved ordering)."""
    return XT.permute(2, 3, 1, 0).reshape(-1, XT.shape[0]).contiguous()


def _ell_scipy(E):
    """A slot-major ELL (cols_t, vals_t) as a scipy csr_matrix, padding dropped."""
    cols, vals = E.cols_t.cpu().numpy(), E.vals_t.double().cpu().numpy()
    rows = np.broadcast_to(np.arange(cols.shape[1]), cols.shape)
    keep = cols >= 0
    return sps.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=E.shape)


def _b6_paths(data, X, offsets):
    """The paths of kernel B6 that apply to X and the offsets."""
    paths = ["strided"]
    if dia_spmm._rows_aligned(X, X):
        paths.append("rows")
    if X.stride(0) == 1 and dia_spmm._plan(tuple(offsets), X.shape[0]) is not None:
        paths.append("blocked")
    return paths


def phase_spmm_kernels(dev, card, gamg_run):
    """Phase 11: B2, B5 and B6 against their plain versions, then timed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    err = {"B2": 0.0, "B5": 0.0, "B6": 0.0}
    b2_vs_b1 = 0.0
    for dtype in (torch.float32, torch.float64):
        for nx, ny in SPARSE_GRIDS:
            assembled = poisson.assemble_poisson(
                nx - 1, ny - 1, dtype=dtype, device=dev, body_force="trig"
            ).A.planes
            rand = torch.randn(assembled.shape, generator=gen, dtype=dtype, device=dev)
            for kind, planes in (("assembled", assembled), ("random-planes", rand)):
                for k in (1, 3, 8):
                    XT = torch.randn((k, 2, ny, nx), generator=gen, dtype=dtype, device=dev)
                    Y = spmm.stencil_spmm(planes, XT)
                    label = f"{nx}x{ny} k={k} {kind}"
                    err["B2"] = max(err["B2"], _compare(
                        f"B2  {label:<36}", Y, spmm.planes_matmat_field(planes, XT), dtype))
                    for j in range(k):
                        b2_vs_b1 = max(b2_vs_b1, _compare(
                            f"B2/B1 {label} field {j}", Y[j], spmv.stencil_spmv(planes, XT[j]), dtype,
                            quiet=True))
    print(f"B2 against B1 field by field (60 batches, both dtypes): max|dy| = {b2_vs_b1:.3e} "
          f"({'bit-equal' if b2_vs_b1 == 0 else 'not bit-equal'})")

    M, A = gamg_run.ksp.M, gamg_run.problem.A
    for dtype in (torch.float32, torch.float64):
        for k, lvl in enumerate(M.levels):
            if isinstance(lvl.A, amg._EllOp):
                E = lvl.A.ell
                x = torch.randn((E.shape[1],), generator=gen, dtype=dtype, device=dev)
                err["B5"] = max(err["B5"], _check_ell(
                    f"gamg level {k} ({E.shape[0]} rows, K={E.cols_t.shape[0]})",
                    E.cols_t, E.vals_t.to(dtype), x, dtype))
        for n in (1000, 100003):
            for width in (1, 7, 33, 64):
                cols_t = torch.randint(0, n, (width, n), generator=gen, device=dev, dtype=torch.int32)
                pad = torch.rand((width, n), generator=gen, device=dev) < 0.25
                cols_t = torch.where(pad, -1, cols_t).to(torch.int32)
                vals_t = torch.randn((width, n), generator=gen, dtype=dtype, device=dev)
                x = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
                err["B5"] = max(err["B5"], _check_ell(f"random n={n} K={width}", cols_t, vals_t, x, dtype))

    b6_vs_b3, b6_cases = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        cases = [(f"{A.shape[0]} rows assembled", A.data.to(dtype), A.offsets)]
        for o, ns in B6_OFFSETS:
            cases += [(f"{len(o)} random bands n={n}",
                       torch.randn((len(o), n), generator=gen, dtype=dtype, device=dev), o) for n in ns]
        for label, data, o in cases:
            n = data.shape[1]
            for k in B6_COLUMNS:
                rows = torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
                for layout, X in (("rows", rows), ("(k,n).T", rows.T.contiguous().T)):
                    Y = dia_spmm.dia_spmm(data, X, o)
                    lab = f"{label} k={k} {layout}"
                    want = dia_spmm.dia_spmm_plain(data, X, o)
                    err["B6"] = max(err["B6"], _compare(f"B6  {lab:<36}", Y, want, dtype))
                    b6_cases += 1
                    for path in _b6_paths(data, X, o):  # each of the kernel's paths that applies
                        err["B6"] = max(err["B6"], _compare(
                            f"B6 {path} path {lab}", dia_spmm._launch(data, X, o, path=path), want, dtype,
                            quiet=True))
                        b6_cases += 1
                    for j in range(k):
                        b6_vs_b3 = max(b6_vs_b3, _compare(
                            f"B6/B3 {lab} col {j}", Y[:, j], dia.dia_spmv_2d(data, X[:, j].contiguous(), o),
                            dtype, quiet=True))
    print(f"B6 against its plain version in {b6_cases} cases: max|dy| = {err['B6']:.3e}; against B3 "
          f"column by column: max|dy| = {b6_vs_b3:.3e} ({'bit-equal' if b6_vs_b3 == 0 else 'not bit-equal'})")
    if err["B6"] != 0 or b6_vs_b3 != 0:
        raise AssertionError("B6 is not bit-equal to its plain version and to B3")

    timings = {}
    nx = ny = N_TIMED
    k = 8
    csr6, E = sparse.to_scipy(A), M.levels[1].A.ell
    csr5 = _ell_scipy(E)
    for dtype in (torch.float32, torch.float64):
        es = torch.finfo(dtype).bits // 8
        dn = str(dtype)[6:]
        st = poisson.assemble_poisson(nx - 1, ny - 1, dtype=dtype, device=dev, body_force="trig").A
        planes = st.planes
        XT = torch.randn((k, 2, *planes.shape[-2:]), generator=gen, dtype=dtype, device=dev)
        # the library call takes the k fields as columns of a row-major (n, k) X
        lib2, X2 = _library_csr(amg._to_scipy(st), dtype, dev), _field_rows(XT)
        _compare("B2 library call against the kernel", lib2 @ X2, _field_rows(spmm.stencil_spmm(planes, XT)), dtype)
        timings["B2", dtype] = _timed(
            "B2", f"{dn:<8} {nx}x{ny} k={k}", card, dtype, (36 + 4 * k) * ny * nx * es, 72 * k * ny * nx,
            lambda: spmm.planes_matmat_field(planes, XT), lambda: spmm.stencil_spmm(planes, XT),
            lambda: lib2 @ X2)
        del lib2, X2
        t_b1 = _median_ms(lambda: [spmv.stencil_spmv(planes, XT[j]) for j in range(k)])
        print(f"B1 x {k} (one field at a time), {dn}: {t_b1 * 1e3:.2f} us  ({card})")

        data = A.data.to(dtype)
        n, nd = data.shape[1], len(A.offsets)
        Xb = torch.randn((k, n), generator=gen, dtype=dtype, device=dev)
        Xr = Xb.T.contiguous()
        lib6 = _library_csr(csr6, dtype, dev)
        _compare("B6 library call against the kernel", lib6 @ Xr, dia_spmm.dia_spmm(data, Xb.T, A.offsets), dtype)
        for key, X, layout in (("B6", Xb.T, "(k,n).T"), ("B6 rows", Xr, "rows")):
            timings[key, dtype] = _timed(
                "B6", f"{dn:<8} {n} rows k={k} {layout}", card, dtype, (nd + 2 * k) * n * es,
                2 * nd * n * k, lambda: dia_spmm.dia_spmm_plain(data, X, A.offsets),
                lambda: dia_spmm.dia_spmm(data, X, A.offsets), lambda: lib6 @ Xr)
        del lib6

        cols_t, vals_t = E.cols_t, E.vals_t.to(dtype)
        K, m = cols_t.shape
        x = torch.randn((E.shape[1],), generator=gen, dtype=dtype, device=dev)
        lib5 = _library_csr(csr5, dtype, dev)
        _compare("B5 library call against the kernel", lib5 @ x, ell.ell_spmv(cols_t, vals_t, x), dtype)
        timings["B5", dtype] = _timed(
            "B5", f"{dn:<8} gamg level 1 ({m} rows, K={K})", card, dtype,
            K * m * (4 + es) + (E.shape[1] + m) * es, 2 * K * m,
            lambda: ell.ell_spmv_plain(cols_t, vals_t, x), lambda: ell.ell_spmv(cols_t, vals_t, x),
            lambda: lib5 @ x)
        del lib5

    # ROADMAP A.25: level 0 of the hierarchy stored as DIA (B3) and as ELL (B5)
    L0 = M.levels[0].A
    E0 = amg._scipy_to_ell(amg._to_scipy(L0), torch.float64, dev)
    K0, n0 = E0.cols_t.shape
    x = torch.randn((n0,), generator=gen, dtype=torch.float64, device=dev)
    y_dia, y_ell = dia.dia_spmv_2d(L0.data, x, L0.offsets), ell.ell_spmv(E0.cols_t, E0.vals_t, x)
    dy = (y_dia - y_ell).abs().max().item() / y_dia.abs().max().item()
    td1, te1, te2, td2 = (_median_ms(f) for f in (
        lambda: dia.dia_spmv_2d(L0.data, x, L0.offsets), lambda: ell.ell_spmv(E0.cols_t, E0.vals_t, x),
        lambda: ell.ell_spmv(E0.cols_t, E0.vals_t, x), lambda: dia.dia_spmv_2d(L0.data, x, L0.offsets)))
    print(
        f"gamg level 0 ({n0} rows, f64): DIA {len(L0.offsets)} bands (B3) {min(td1, td2) * 1e3:.2f} us, "
        f"ELL width {K0} (B5) {min(te1, te2) * 1e3:.2f} us; medians in turn (B3, B5, B5, B3): "
        f"{td1 * 1e3:.2f} {te1 * 1e3:.2f} {te2 * 1e3:.2f} {td2 * 1e3:.2f} us; "
        f"|y_dia - y_ell|/max|y| = {dy:.3e}  ({card})"
    )
    if not dy <= 1e-12:
        raise AssertionError(f"level 0 as ELL disagrees with level 0 as DIA: {dy}")
    del E0
    return err, timings


def _mat_solve(A, B, argv):
    """KSPMatSolve with the counts set to 0 just before; returns the KSP,
    the result, the seconds of PCSetUp and of the solve, and the launches."""
    ksp = KSP(Options(["-ksp_type", "cg"] + argv))
    ksp.set_operators(A).set_from_options()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    ksp.set_up()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = ksp.mat_solve(B)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()
    its = res.iterations
    print(
        f"KSPMatSolve {' '.join(argv)}: k={B.shape[0]}, {its} its, reasons "
        f"{res.converged_reason.tolist()}, PCSetUp {t1 - t0:.4f} s, solve {t2 - t1:.4f} s "
        f"({(t2 - t1) / its * 1e3:.4f} ms/it); launches "
        f"{' '.join(f'{k} {v}' for k, v in counts.items())}"
    )
    if res.converged_reason.tolist() != [krylov.CONVERGED_RTOL] * B.shape[0]:
        raise AssertionError(f"KSPMatSolve did not converge: {res.converged_reason.tolist()}")
    return ksp, res, t1 - t0, t2 - t1, counts


def _column_its(res, rtol, atol=1e-50):
    """Each column's iteration count, from the history: the first iteration
    whose residual norm passed the column's test."""
    hist, bnorm = res.history, res.rnorm0
    return [
        next(j for j in range(res.iterations + 1) if hist[j, c] <= max(rtol * bnorm[c].item(), atol))
        for c in range(hist.shape[1])
    ]


def _true_residuals(Ab, X, B):
    """Per-column |b - A x| / |b| in f64."""
    R = (B - Ab(X)).double().reshape(B.shape[0], -1)
    return (R.norm(dim=1) / B.double().reshape(B.shape[0], -1).norm(dim=1)).tolist()


def phase_mat_solve_stencil(dev):
    """Phase 12: KSPMatSolve on the stencil through B2."""
    n, k = 1025, 8
    prob = poisson.assemble_poisson(n - 1, n - 1, dtype=torch.float32, device=dev)
    B = torch.stack([prob.f * (1.0 + 0.1 * i) for i in range(k)])
    ksp, res, _, t, counts = _mat_solve(prob.A, B, ["-pc_type", "jacobi", "-ksp_rtol", "1e-5"])
    if counts["B2"] < res.iterations:
        raise AssertionError(f"B2 launched {counts['B2']} times for {res.iterations} iterations")
    planes64 = prob.A.planes.double()
    rel = _true_residuals(lambda X: spmm.planes_matmat_field(planes64, X), res.x.double(), B)
    # an f32 solution cannot leave a small true residual here: kappa(A) is
    # about 5e5 at 1025^2 nodes, times f32's 6e-8, so the yardstick is a
    # single-right-hand-side f32 CG (kernel B1) of column 0
    single = krylov.cg(prob.A, B[0], M=ksp.M, rtol=1e-5, maxiter=10000)
    rel_s = _true_residuals(lambda X: spmm.planes_matmat_field(planes64, X), single.x[None].double(), B[:1])[0]
    print(f"{n}^2 f32 k={k} CG+Jacobi: {res.iterations} its, {t / res.iterations * 1e3:.4f} ms/it, "
          f"per-column iterations {_column_its(res, 1e-5)}, true residuals (f64) "
          f"{', '.join(f'{r:.3e}' for r in rel)}; single-RHS CG of column 0: {single.iterations} its, "
          f"true residual {rel_s:.3e}")
    if not max(rel) <= 2.0 * rel_s:
        raise AssertionError(f"true residuals {rel}, single-RHS {rel_s}")
    launches = counts["B2"]

    n, k = 257, 4
    prob = poisson.assemble_poisson(n - 1, n - 1, dtype=torch.float64, device=dev, body_force="trig")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    f = prob.f
    B = torch.stack([f, 2.0 * f, f * f, torch.randn(f.shape, generator=gen, dtype=f.dtype, device=dev)])
    ksp, res, _, t, counts = _mat_solve(prob.A, B, ["-pc_type", "jacobi", "-ksp_rtol", "1e-8"])
    launches += counts["B2"]
    cols = _column_its(res, 1e-8)
    b1 = _launches("B1")
    singles = [krylov.cg(prob.A, B[j], M=ksp.M, rtol=1e-8, maxiter=10000) for j in range(k)]
    if _launches("B1") - b1 < sum(r.iterations for r in singles):
        raise AssertionError("the single-right-hand-side solves did not run through B1")
    dxs = [(krylov.tnorm(res.x[j] - r.x) / krylov.tnorm(r.x)).item() for j, r in enumerate(singles)]
    print(f"{n}^2 f64 k={k} CG+Jacobi: batched per-column iterations {cols}, single-RHS "
          f"{[r.iterations for r in singles]}, |x_batched - x_single|/|x_single| "
          f"{', '.join(f'{d:.3e}' for d in dxs)}; {t / res.iterations * 1e3:.4f} ms/it batched")
    if any(abs(c - r.iterations) > 1 for c, r in zip(cols, singles)) or not max(dxs) <= 1e-9:
        raise AssertionError(f"batched and single solves differ: {cols}, {dxs}")
    return launches


def phase_mat_solve_dia(dev, gamg_run):
    """Phase 13: KSPMatSolve with gamg on the 1025^2 DIA operator."""
    A, f = gamg_run.problem.A, gamg_run.problem.f
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B = torch.stack([f, 2.0 * f, f * f, torch.randn(f.shape, generator=gen, dtype=f.dtype, device=dev)])
    _, res, t_setup, t, counts = _mat_solve(A, B, ["-pc_type", "gamg", "-ksp_rtol", "1e-10"])
    for name in ("B6", "B3", "B5"):
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched")
    if counts["B6"] < res.iterations:
        raise AssertionError(f"B6 launched {counts['B6']} times for {res.iterations} iterations")
    rel = _true_residuals(lambda X: dia_spmm.dia_spmm_plain(A.data, X.T, A.offsets).T, res.x, B)
    print(f"1025^2 f64 k=4 CG+gamg: {res.iterations} its, per-column iterations "
          f"{_column_its(res, 1e-10)}, PCSetUp {t_setup:.3f} s, solve {t:.4f} s "
          f"({t / res.iterations * 1e3:.3f} ms/it), true residuals (f64, plain matvec) "
          f"{', '.join(f'{r:.3e}' for r in rel)}")
    if not max(rel) <= 1e-6:
        raise AssertionError(f"true residuals {rel} > 1e-6")
    return counts["B6"]


def phase_mat_solve_dia_f32(dev, gamg_run, b6_ms):
    """Phase 14: KSPMatSolve on phase 8's 1025^2 DIA operator in f32, k = 8,
    CG + Jacobi: B6 once per iteration, thousands of times."""
    A64, f = gamg_run.problem.A, gamg_run.problem.f.float()
    A = sparse.DIA(A64.data.float(), A64.offsets, A64.shape)
    k = 8
    B = torch.stack([f * (1.0 + 0.1 * i) for i in range(k)])
    ksp, res, _, t, counts = _mat_solve(A, B, ["-pc_type", "jacobi", "-ksp_rtol", "1e-5"])
    its = res.iterations
    if not its <= counts["B6"] <= its + 2:  # one per iteration and one for the first residual
        raise AssertionError(f"B6 launched {counts['B6']} times for {its} iterations")
    plain64 = lambda X: dia_spmm.dia_spmm_plain(A64.data, X.T, A64.offsets).T  # noqa: E731
    rel = _true_residuals(plain64, res.x.double(), B)
    # as in phase 12, an f32 solution has a residual floor at this size: the
    # yardstick is a single-right-hand-side f32 CG (kernel B3) of column 0
    single = krylov.cg(A, B[0], M=ksp.M, rtol=1e-5, maxiter=10000)
    rel_s = _true_residuals(plain64, single.x[None].double(), B[:1])[0]
    share = counts["B6"] * b6_ms * 1e-3 / t
    print(f"1025^2 DIA f32 k={k} CG+Jacobi: {its} its, solve {t:.4f} s, {t / its * 1e3:.4f} ms/it, "
          f"B6 {counts['B6']} launches x {b6_ms * 1e3:.2f} us (phase 11) = {share:.1%} of the solve; "
          f"per-column iterations {_column_its(res, 1e-5)}, true residuals (f64) "
          f"{', '.join(f'{r:.3e}' for r in rel)}; single-RHS CG of column 0: {single.iterations} its, "
          f"true residual {rel_s:.3e}")
    if not max(rel) <= 2.0 * rel_s:
        raise AssertionError(f"true residuals {rel}, single-RHS {rel_s}")
    return counts["B6"]



MG_GRID = 1025  # node grid side of phases 15-17's largest runs: eight MG levels, 1025 -> 5


def phase_mg(dev):
    """Phase 15: the MG hierarchy at 1025^2 f32 on the card."""
    n = MG_GRID
    A = poisson.assemble_poisson(n - 1, n - 1, dtype=torch.float32, device=dev, body_force="trig").A
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    M = multigrid.mg_pc(A, smoother="chebyshev")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    grids = [lvl.A.grid_shape[0] for lvl in M.levels]
    n_c = M.coarse_inv.shape[0]
    print(f"{n}^2 f32 mg_pc(chebyshev): setup {t_setup:.3f} s, {len(M.levels)} levels {grids}, "
          f"coarse {n_c} dofs, B1 launches in setup {_launches("B1")}")
    if len(M.levels) != 8 or n_c != 50:
        raise AssertionError(f"expected 8 levels down to 5x5 nodes, got {grids} and {n_c} coarse dofs")

    # each level's coarse planes against a CPU f64 build from the same planes
    ref = StencilOperator(A.planes.double().cpu())
    for k in range(1, len(M.levels)):
        ref = multigrid.galerkin_coarse_stencil(ref)
        _compare(f"MG level {k} Galerkin planes ({ref.grid_shape[0]}^2) against CPU f64",
                 M.levels[k].A.planes.double().cpu(), ref.planes, torch.float32)
    ref = multigrid.galerkin_coarse_stencil(ref)  # the coarsest, 5^2
    coarse = multigrid.galerkin_coarse_stencil(M.levels[-1].A)
    _compare("MG coarsest Galerkin planes (5^2) against CPU f64", coarse.planes.double().cpu(), ref.planes,
             torch.float32)

    # B1 at every level's grid, down to 9^2 and the 5^2 coarsest
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for op in [lvl.A for lvl in M.levels] + [coarse]:
        for dtype in (torch.float32, torch.float64):
            planes = op.planes.to(dtype)
            x = torch.randn((2, *op.grid_shape), generator=gen, dtype=dtype, device=dev)
            _compare(f"B1  MG level grid {op.grid_shape[0]}^2", spmv.stencil_spmv(planes, x),
                     spmv.planes_matvec_field(planes, x), dtype)

    # one V-cycle against the same hierarchy built and applied on the CPU
    # (estimate_lmax's start is counter-based, kernel RN here and its twin
    # on the CPU, so both start alike to a few ulp)
    r = torch.randn((2, n, n), generator=gen, dtype=torch.float32, device=dev)
    M_cpu = multigrid.mg_pc(StencilOperator(A.planes.cpu()), smoother="chebyshev")
    _reset_counts()
    z = M(r)
    torch.cuda.synchronize()
    per_cycle = _launches("B1")
    err = _compare("MG V-cycle on the card against the CPU", z.cpu(), M_cpu(r.cpu()), torch.float32)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        z = M(r)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"MG V-cycle at {n}^2 f32: {per_cycle} B1 launches, {ms:.3f} ms (host clock, {reps} in a row), "
          f"max|dz| against the CPU {err:.3e}")
    if per_cycle < 2 * len(M.levels):
        raise AssertionError(f"{per_cycle} B1 launches in a V-cycle of {len(M.levels)} levels")


def phase_saddle_mg(minres):
    """Phase 16: the saddle route at 1025^2 f32 with FGMRES and a Schur PC
    whose A-block solve is the MG V-cycle: the upper factorization, which
    must converge, and the full one (the JAX bench's), capped at 200
    iterations, which f32 breaks at this size."""
    n = MG_GRID
    base = [
        "-device", "cuda", "-problem_type", "saddle", "-body_force", "trig",
        "-da_grid_x", str(n), "-da_grid_y", str(n), "-dtype", "f32", "-ksp_rtol", "1e-5",
        "-ksp_type", "fgmres", "-pc_type", "fieldsplit", "-fieldsplit_inner_pc_type", "mg",
        "-pc_mg_smoother", "chebyshev", "-ksp_converged_reason", "-log_view", "-no_vtk",
    ]
    for fact in ("upper", "full"):
        argv = base + ["-pc_fieldsplit_schur_fact_type", fact]
        if fact == "upper":
            run, counts = _cli(argv)
        else:
            # FGMRES converges on its own (Arnoldi) residual only while the
            # PC keeps its digits. In f32 the full factorization loses them:
            # its Schur approximation B D^-1 B^T is about h^-2 smaller than
            # the MG block's B A^-1 B^T, so zlam and A^-1 B^T zlam grow by
            # that factor and cancel in zu (the JAX package does the same,
            # tests/test_torch_multigrid.py). Uncapped, this run took 8101
            # iterations to DIVERGED_DTOL on the H100.
            print("$ python -m saddle_point_petsc_tpu_torch.cli " + " ".join(argv + ["-ksp_max_it", "200"]))
            _reset_counts()
            run = cli.run(argv + ["-ksp_max_it", "200"])
            counts = _counts()
        prob, res = run.problem, run.result
        t_setup, t_solve = (run.log.phases[p].total_s for p in ("PCSetUp", "KSPSolve"))
        true_rel = dist_probe.true_rel_kkt(prob.A.planes.double(), prob.Bf.double(), prob.rhs, res.x)
        its = res.iterations
        print(
            f"{n}^2 f32 FGMRES + Schur({fact}, MG chebyshev): {its} its, {res.reason_name()}, PCSetUp "
            f"{t_setup:.3f} s, KSPSolve {t_solve:.4f} s ({t_solve / its * 1e3:.3f} ms/it), B1 launches "
            f"{counts['B1']} ({counts['B1'] / its:.1f} per iteration), true residual {true_rel:.3e} (f64); "
            f"phase 5's MINRES + Jacobi: {minres['its']} its, {minres['solve_s']:.4f} s "
            f"({minres['solve_s'] / minres['its'] * 1e3:.3f} ms/it), true residual {minres['true_rel']:.3e}; "
            f"KSPSolve ratio MINRES/FGMRES-MG {minres['solve_s'] / t_solve:.2f}"
        )
        if counts["B1"] < its:
            raise AssertionError(f"B1 launched {counts['B1']} times for {its} iterations")
        # the upper factorization leaves a true residual near f32's floor
        if fact == "upper" and not true_rel <= 0.1:
            raise AssertionError(f"Schur(upper): true residual {true_rel}")


def phase_refine(dev, minres_f64):
    """Phase 17: refinement to rtol 1e-8 with the FGMRES-MG inner solve
    (the JAX bench's configuration, full Schur factorization), and with the
    upper factorization, which f32 does not break at 1025^2."""
    for n in (257, MG_GRID):
        prob = saddle.assemble_saddle(n - 1, n - 1, dtype=torch.float64, device=dev, body_force="trig")
        planes64, Bf64 = prob.A.planes, prob.Bf
        for fact in ("full", "upper"):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            A32 = StencilOperator(planes64.float())
            K32 = SaddleOperator(A32, Bf64.float())
            M = precond.schur_pc(A32, K32.Bf, inner_solve=multigrid.mg_pc(A32, smoother="chebyshev"),
                                 fact_type=fact)
            torch.cuda.synchronize()
            t1 = time.perf_counter()

            def inner(ru, rlam, ops):
                res = krylov.fgmres(ops[0], (ru, rlam), M=ops[1], rtol=1e-3, maxiter=60, restart=30)
                return res.x, res.iterations

            # the bench's full factorization diverges in f32 at 1025^2
            # (phase 16): three cycles show it
            broken = (n, fact) == (MG_GRID, "full")
            run = refine.solve_refined_kkt_fused(
                K32, prob.rhs, rtol=1e-8, max_cycles=3 if broken else 30, planes_df=planes64, Bf_df=Bf64,
                inner_rtol=1e-3, inner_maxiter=1500, inner=inner, inner_operands=(K32, M),
            )
            x, cycles, inner_its, rn, rn0 = run()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            b1 = _launches("B1")
            true_rel = dist_probe.true_rel_kkt(planes64, Bf64, prob.rhs, x)
            line = (f"{n}^2 refinement, f64 residual, f32 FGMRES + Schur({fact}, MG chebyshev) inner: {cycles} "
                    f"cycles, {inner_its} inner its, setup {t1 - t0:.3f} s, solve {t2 - t1:.4f} s, B1 launches "
                    f"{b1}, |r|/|b| {rn / rn0:.3e} (loop), true relative residual {true_rel:.3e} (f64, plain)")
            if n == 257:
                line += (f"; phase 4's direct f64 MINRES: {minres_f64['its']} its, {minres_f64['solve_s']:.4f} s, "
                         f"ratio {minres_f64['solve_s'] / (t2 - t1):.2f}")
            print(line)
            if b1 == 0 or x[0].dtype != torch.float64:
                raise AssertionError(f"refinement at {n}^2: {b1} B1 launches, x {x[0].dtype}")
            if not broken and not true_rel <= 1e-8:
                raise AssertionError(f"refinement at {n}^2 Schur({fact}): true residual {true_rel}")
            del A32, K32, M, x
        # the direct f64 solve with the same PC: FGMRES + Schur(upper, MG)
        # in f64 to rtol 1e-8
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        M = precond.schur_pc(prob.A, prob.Bf, inner_solve=multigrid.mg_pc(prob.A, smoother="chebyshev"),
                             fact_type="upper")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = krylov.fgmres(prob.K, prob.rhs, M=M, rtol=1e-8, maxiter=300, restart=30)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        true_rel = dist_probe.true_rel_kkt(planes64, Bf64, prob.rhs, res.x)
        print(f"{n}^2 direct f64 FGMRES + Schur(upper, MG chebyshev): {res.iterations} its, {res.reason_name()}, "
              f"setup {t1 - t0:.3f} s, solve {t2 - t1:.4f} s ({(t2 - t1) / max(res.iterations, 1) * 1e3:.3f} ms/it), "
              f"B1 launches {_launches("B1")}, true relative residual {true_rel:.3e}")
        if not true_rel <= 1e-7:
            raise AssertionError(f"direct f64 FGMRES-MG at {n}^2: true residual {true_rel}")
        del prob, planes64, Bf64, M, res


def phase_sweep():
    """Phase 18: the new PC and KSP types through the CLI."""
    g257 = ["-device", "cuda", "-dtype", "f64", "-da_grid_x", "257", "-da_grid_y", "257",
            "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-no_vtk"]
    runs = [
        (["-ksp_type", "cg", "-pc_type", "pbjacobi"], ("B1",)),
        (["-ksp_type", "cg", "-pc_type", "sor"], ("B1",)),
        # 512 blocks of 259 rows: the default 4 would be capped at 33 of
        # 4003, and 128 of 1033 took 8.2 s of host inverses on the H100's host
        (["-ksp_type", "cg", "-pc_type", "bjacobi", "-pc_bjacobi_blocks", "512"], ("B1",)),
        (["-ksp_type", "cg", "-pc_type", "chebyshev", "-pc_chebyshev_esteig"], ("B1",)),
        (["-ksp_type", "cg", "-pc_type", "fieldsplit"], ("B1",)),
        (["-ksp_type", "cg", "-pc_type", "mg"], ("B1",)),
        (["-ksp_type", "bcgs", "-pc_type", "mg"], ("B1",)),
        (["-ksp_type", "chebyshev", "-pc_type", "mg"], ("B1",)),
        (["-ksp_type", "richardson", "-pc_type", "mg", "-ksp_max_it", "20"], ("B1",)),
        (["-ksp_type", "bcgs", "-mat_type", "dia"], ("B3",)),
        # BASELINE config 1: the 64 x 64-element grid, MINRES, block Jacobi
        (["-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "65", "-da_grid_y", "65",
          "-ksp_type", "minres", "-pc_type", "fieldsplit", "-fieldsplit_inner_pc_type", "bjacobi"], ("B1",)),
        # BASELINE config 3's solver on the 256 x 256-element grid
        (["-problem_type", "saddle", "-body_force", "trig", "-ksp_type", "fgmres", "-pc_type", "fieldsplit",
          "-fieldsplit_inner_ksp_type", "cg", "-fieldsplit_inner_pc_type", "mg"], ("B1",)),
    ]
    for extra, kernels in runs:
        t0 = time.perf_counter()
        run, counts = _cli(g257 + ["-log_view"] + extra, kernels)
        t_setup, t_solve = (run.log.phases[p].total_s for p in ("PCSetUp", "KSPSolve"))
        print(f"  PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, "
              f"{t_solve / max(run.result.iterations, 1) * 1e3:.3f} ms/it; whole run {time.perf_counter() - t0:.2f} s")


def _phases(run):
    """(PCSetUp s, KSPSolve s, ms per iteration) of a CLI run."""
    t_setup, t_solve = (run.log.phases[p].total_s for p in ("PCSetUp", "KSPSolve"))
    return t_setup, t_solve, t_solve / max(run.result.iterations, 1) * 1e3


def _ilu_apply_check(label, M, M_cpu, r, dtype, launches):
    """One apply on the card against the CPU's, with exactly `launches` B1
    launches; returns its host milliseconds (the median of 5 in a row)."""
    _reset_counts()
    z = M(r)
    torch.cuda.synchronize()
    if not z.is_cuda:
        raise AssertionError(f"{label}: the apply left the card")
    if _launches("B1") != launches:
        raise AssertionError(f"{label}: {_launches("B1")} B1 launches per apply, expected {launches}")
    err = _compare(f"{label} apply on the card against the CPU", z.cpu(), M_cpu(r.cpu()), dtype)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        M(r)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"  {label}: {launches} B1 launches per apply, {statistics.median(times):.3f} ms per apply "
          f"(host clock), max|dz| {err:.3e}")
    return statistics.median(times)


def phase_ilu(dev, tmp, jacobi_1025):
    """Phase 19: ILU(0) on the card (host factorization, B1 sweeps, the
    level-scheduled exact solves, checkpoint and resume)."""
    if not native.available():
        raise AssertionError("the native host library did not load (ILU(0) would take minutes in Python)")
    n, f64 = 257, torch.float64
    A = poisson.assemble_poisson(n - 1, n - 1, dtype=f64, device=dev, body_force="trig").A
    A_cpu = StencilOperator(A.planes.cpu())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = ilu_stencil.stencil_ilu0(A, sweeps=6)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    M_cpu = ilu_stencil.stencil_ilu0(A_cpu, sweeps=6)
    for name in ("Lp", "Up", "invd"):
        _compare(f"ILU {n}^2 {name} built on the card against the CPU", getattr(M, name).cpu(),
                 getattr(M_cpu, name), f64)
    print(f"{n}^2 f64 stencil_ilu0 (sweeps 6): setup {t_setup:.3f} s (native factorization)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    r = torch.randn((2, n, n), generator=gen, dtype=f64, device=dev)
    _ilu_apply_check(f"StencilILU0PC {n}^2 f64", M, M_cpu, r, f64, 12)
    A32 = StencilOperator(A.planes.float())
    _ilu_apply_check(f"StencilILU0PC {n}^2 f32", ilu_stencil.stencil_ilu0(A32, sweeps=6),
                     ilu_stencil.stencil_ilu0(StencilOperator(A32.planes.cpu()), sweeps=6), r.float(),
                     torch.float32, 12)

    # the CLI at 257^2 f64 to rtol 1e-8
    g257 = ["-dtype", "f64", "-da_grid_x", str(n), "-da_grid_y", str(n), "-ksp_rtol", "1e-8",
            "-ksp_converged_reason", "-log_view", "-no_vtk"]
    cg_ilu = g257 + ["-ksp_type", "cg", "-pc_type", "ilu"]
    its = {}
    for label, argv, kernels in (
        ("CG + ILU, stencil", cg_ilu, ("B1",)),
        ("CG + ILU, -mat_type aij", cg_ilu + ["-mat_type", "aij"], ()),
        ("GMRES + ILU, stencil", g257 + ["-ksp_type", "gmres", "-pc_type", "ilu"], ("B1",)),
        ("FGMRES + Schur(upper, ILU), saddle", g257 + [
            "-problem_type", "saddle", "-body_force", "trig", "-ksp_type", "fgmres", "-pc_type", "fieldsplit",
            "-pc_fieldsplit_schur_fact_type", "upper", "-fieldsplit_inner_pc_type", "ilu"], ("B1",)),
    ):
        run, counts = _cli(["-device", "cuda"] + argv, kernels)
        t_setup, t_solve, ms = _phases(run)
        its[label] = run.result.iterations
        print(f"  {n}^2 f64 {label}: {its[label]} its, PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, "
              f"{ms:.3f} ms/it, B1 launches {counts['B1']} ({counts['B1'] / its[label]:.1f} per iteration)")
        if label == "CG + ILU, stencil":
            cold = run
    t0 = time.perf_counter()
    host = cli.run(["-device", "cpu"] + cg_ilu)
    t_host = time.perf_counter() - t0
    its["CG + ILU, stencil, CPU"] = host.result.iterations
    print(f"  {n}^2 f64 CG + ILU iterations: {its}; the CPU run {host.result.reason_name()} in {t_host:.2f} s "
          f"(KSPSolve {_phases(host)[1]:.3f} s)")
    if not (host.rc == 0 and abs(its["CG + ILU, stencil"] - its["CG + ILU, -mat_type aij"]) <= 2
            and abs(its["CG + ILU, stencil"] - host.result.iterations) <= 2):
        raise AssertionError(f"CG + ILU iteration counts disagree: {its}")

    # checkpoint: a CG + ILU solve stopped at rtol 1e-4 on the card, saved
    # through the host, loaded back onto the card and resumed to 1e-8
    prob, M = cold.problem, cold.ksp.M
    partial = krylov.cg(prob.A, prob.f, M=M, rtol=1e-4, maxiter=10000)
    path = checkpoint.save_solver_state(os.path.join(tmp, "cg_ilu_1e-4.npz"), partial, meta={"rtol": 1e-4})
    back = checkpoint.load_like(path, partial)
    if not (back.x.is_cuda and torch.equal(back.x, partial.x)):
        raise AssertionError("the checkpointed iterate did not come back to the card unchanged")
    resumed = checkpoint.resume_solve(krylov.cg, prob.A, prob.f, path, partial, M=M, rtol=1e-8, maxiter=10000)
    print(f"  checkpoint: CG + ILU to 1e-4 in {partial.iterations} its, saved and reloaded onto the card, "
          f"resumed to 1e-8 in {resumed.iterations} its ({resumed.reason_name()}) against "
          f"{cold.result.iterations} cold")
    if resumed.reason_name() != "CONVERGED_RTOL" or not resumed.iterations < cold.result.iterations:
        raise AssertionError(f"resume: {resumed.reason_name()} in {resumed.iterations} its")
    del cold, host, prob, M, A, A32, M_cpu

    # the exact path (-mat_type aij -pc_ilu_sweeps 0) at 65^2 f64
    M0 = precond.ilu0(poisson.assemble_poisson_csr(64, 64, dtype=f64, device=dev)[0], sweeps=0)
    M0_cpu = precond.ilu0(poisson.assemble_poisson_csr(64, 64, dtype=f64, device="cpu")[0], sweeps=0)
    ms0 = _ilu_apply_check(f"exact ILU(0) 65^2 f64 ({M0.lower.levels} + {M0.upper.levels} levels)", M0, M0_cpu,
                           torch.randn((2, 65, 65), generator=gen, dtype=f64, device=dev), f64, 0)
    run, counts = _cli(["-device", "cuda", "-dtype", "f64", "-da_grid_x", "65", "-da_grid_y", "65", "-mat_type",
                        "aij", "-ksp_type", "cg", "-pc_type", "ilu", "-pc_ilu_sweeps", "0", "-ksp_rtol", "1e-8",
                        "-ksp_converged_reason", "-log_view", "-no_vtk"], kernels=())
    t_setup, t_solve, ms = _phases(run)
    print(f"  65^2 f64 CG + ILU(exact): {run.result.iterations} its, PCSetUp {t_setup:.3f} s, KSPSolve "
          f"{t_solve:.4f} s, {ms:.3f} ms/it ({ms0:.3f} ms per PC apply)")

    # the full size: 1025^2 f32 GMRES + ILU on the stencil
    argv = ["-device", "cuda", "-dtype", "f32", "-da_grid_x", "1025", "-da_grid_y", "1025", "-ksp_type", "gmres",
            "-pc_type", "ilu", "-ksp_rtol", "1e-5", "-ksp_max_it", "3000", "-ksp_converged_reason", "-log_view",
            "-no_vtk"]
    print("$ python -m saddle_point_petsc_tpu_torch.cli " + " ".join(argv), flush=True)
    _reset_counts()
    run = cli.run(argv)
    b1 = _launches("B1")
    res, prob = run.result, run.problem
    t_setup, t_solve, ms = _phases(run)
    planes64 = prob.A.planes.double()
    x64 = res.x.double()
    true_rel = ((prob.f.double() - spmv.planes_matvec_field(planes64, x64)).norm() / prob.f.double().norm()).item()
    print(f"  1025^2 f32 GMRES + ILU: {res.iterations} its, {res.reason_name()}, PCSetUp {t_setup:.3f} s (host "
          f"factorization of {prob.A.n} rows), KSPSolve {t_solve:.4f} s, {ms:.3f} ms/it, B1 launches {b1} "
          f"({b1 / max(res.iterations, 1):.1f} per iteration), true residual {true_rel:.3e} (f64); phase 9's CG + "
          f"Jacobi (block-DIA): {jacobi_1025['its']} its, {jacobi_1025['solve_s']:.4f} s "
          f"({jacobi_1025['solve_s'] / jacobi_1025['its'] * 1e3:.4f} ms/it)")
    if res.reason_name() in ("DIVERGED_DTOL", "DIVERGED_NANORINF") or not np.isfinite(true_rel):
        raise AssertionError(f"1025^2 GMRES + ILU: {res.reason_name()}, true residual {true_rel}")


DIST_GRID = 704  # BASELINE config 4: 704^2 nodes, 991,236 rows with the 4 constraint rows


def _dist_functions(dev, mesh, card):
    """Phase 20 (d): the halo and matvec functions on CUDA tensors."""
    n, f32 = DIST_GRID, torch.float32
    t0 = time.perf_counter()
    A, f, _ = pdist.assemble_poisson_dist(pdist.DistGrid.create(n - 1, n - 1, mesh), dtype=f32, body_force="trig")
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    serial = poisson.assemble_poisson(n - 1, n - 1, dtype=f32, device=dev, body_force="trig")
    # kernel FE sums in its own order: within rounding of the serial batched products
    d_planes, d_f = ((a - b).abs().max().item() for a, b in ((A.planes, serial.A.planes), (f, serial.f)))
    if not (d_planes <= _fe_tol(serial.A.planes, f32) and d_f <= _fe_tol(serial.f, f32, "load")):
        raise AssertionError(f"the world-of-one assembly differs from the serial one: {d_planes}, {d_f}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    x = torch.randn((2, n, n), generator=gen, dtype=f32, device=dev)
    xp = halo.halo_exchange_1phase(x, mesh)
    if not (xp.is_cuda and torch.equal(xp, F.pad(x, (1, 1, 1, 1))) and torch.equal(halo.halo_exchange(x, mesh), xp)
            and torch.equal(halo.halo_add(xp, mesh), x)):
        raise AssertionError("halo exchange or halo_add disagrees with zero padding")
    print(f"  {n}^2 f32: distributed assembly {t_asm:.3f} s, within 4 ulp of the serial one (planes "
          f"{d_planes:.3e}, f {d_f:.3e}); halo_exchange_1phase, "
          "halo_exchange and halo_add equal zero padding and cropping on the card")
    ref = serial.A(x)
    forms = {}
    # the matvec (overlap form: B1's local entry) and one field through the
    # SpMM (B1's padded entry on the exchanged patch)
    for label, entry, op in (("overlap", "stencil_spmv", lambda: A(x)),
                             ("padded", "stencil_spmv_padded", lambda: A.matmat_field(x[None])[0])):
        _reset_counts()
        y = op()
        if _launches("B1") != 1 or _entry_launches()[entry] != 1:
            raise AssertionError(f"distributed matvec ({label} form): launches {_entry_launches()}")
        _compare(f"distributed matvec, {label} form, against the serial B1", y, ref, f32)
        forms[entry] = _median_ms(op)
    t_serial = _median_ms(lambda: serial.A(x))
    print(f"  {n}^2 f32 matvec device time (median of 60, CUDA events): serial B1 {t_serial * 1e3:.2f} us, "
          f"distributed overlap form {forms['stencil_spmv'] * 1e3:.2f} us, padded form "
          f"{forms['stencil_spmv_padded'] * 1e3:.2f} us ({card})")


def phase_dist(dev, tmp, card):
    """Phase 20: the distributed stencil path in a world of one on NCCL.
    Returns config 4's iteration count on the -dist route (the bench's)."""
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(tmp, "nccl_store"), 1), rank=0,
                             world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=300))
    try:
        if tdist.get_backend() != "nccl":
            raise AssertionError(f"backend {tdist.get_backend()}, not nccl")
        mesh = pmesh.ProcessMesh.create(device=dev)
        _dist_functions(dev, mesh, card)

        # (a) BASELINE config 4 through the CLI, and (b) the serial route
        n = DIST_GRID
        common = ["-device", "cuda", "-problem_type", "saddle", "-da_grid_x", str(n), "-da_grid_y", str(n),
                  "-dtype", "f32", "-body_force", "trig", "-ksp_rtol", "1e-5", "-ksp_converged_reason",
                  "-log_view", "-no_vtk"]
        argvs = {
            "dist": common + ["-dist", "-fieldsplit_inner_pc_type", "bjacobi", "-sub_pc_type", "chebyshev",
                              "-pc_bjacobi_local_its", "4"],
            "serial": common + ["-fieldsplit_inner_pc_type", "chebyshev", "-pc_chebyshev_esteig",
                                "-pc_chebyshev_its", "4"],
        }
        out = {}
        # host-bound times vary between runs: dist, serial, serial, dist,
        # each route keeping its faster run
        for label in ("dist", "serial", "serial", "dist"):
            run, counts = _cli(argvs[label])
            entries = _entry_launches()
            res, prob = run.result, run.problem
            its = res.iterations
            t_asm, t_setup, t_solve = (run.log.phases[p].total_s for p in ("Assembly", "PCSetUp", "KSPSolve"))
            true_rel = dist_probe.true_rel_kkt(prob.A.planes.double(), prob.Bf.double(), prob.rhs, res.x)
            if label in out and its != out[label]["its"]:
                raise AssertionError(f"{label}: {its} its, the first run took {out[label]['its']}")
            ms = min(t_solve / its * 1e3, out.get(label, {}).get("ms", float("inf")))
            out[label] = {"its": its, "ms": ms, "x": res.x}
            print(f"  {n}^2 f32 config 4, {label}: {its} its, {res.reason_name()}, Assembly {t_asm:.3f} s, "
                  f"PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, {t_solve / its * 1e3:.4f} ms/it, B1 "
                  f"{counts['B1']} launches ({counts['B1'] / its:.2f} per iteration: local entry "
                  f"{entries['stencil_spmv'] / its:.2f}, padded entry {entries['stencil_spmv_padded'] / its:.2f}), "
                  f"true residual {true_rel:.3e} (f64) ({card})")
            if label == "dist" and not (isinstance(prob, cli.DistProblem) and prob.A.mesh.size == 1):
                raise AssertionError("the -dist run did not take the distributed route")
            if not np.isfinite(true_rel):
                raise AssertionError(f"{label}: true residual {true_rel}")
        xd, xs = out["dist"]["x"], out["serial"]["x"]
        dx = (krylov.tnorm(krylov.tsub(xd, xs)) / krylov.tnorm(xs)).item()
        print(f"  config 4 at world size 1: distributed {out['dist']['its']} its, serial {out['serial']['its']} its, "
              f"|x_dist - x_serial|/|x_serial| = {dx:.3e}, ms per iteration (the faster of two runs each) "
              f"{out['dist']['ms']:.4f} / {out['serial']['ms']:.4f} = {out['dist']['ms'] / out['serial']['ms']:.3f}")
        # the routes' operators differ by rounding (kernel FE against the
        # batched products, 4 ulp in f32), which f32 MINRES carries into x:
        # 438 against 437 its and dx 3.777e-5 on an H100
        if abs(out["dist"]["its"] - out["serial"]["its"]) > 1 or not dx <= 5e-5:
            raise AssertionError(f"the distributed and serial routes disagree: {out['dist']['its']} vs "
                                 f"{out['serial']['its']} its, dx {dx}")

        # (c) per-patch ILU(0) against the serial ILU(0), 257^2 f64
        g257 = ["-device", "cuda", "-dtype", "f64", "-da_grid_x", "257", "-da_grid_y", "257", "-ksp_type", "gmres",
                "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-log_view", "-no_vtk"]
        its = {}
        for label, argv in (("dist bjacobi + ILU", g257 + ["-dist", "-pc_type", "bjacobi", "-sub_pc_type", "ilu"]),
                            ("serial ILU", g257 + ["-pc_type", "ilu"])):
            run, counts = _cli(argv)
            t_setup, t_solve, ms = _phases(run)
            its[label] = run.result.iterations
            print(f"  257^2 f64 GMRES + {label}: {its[label]} its, PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, "
                  f"{ms:.3f} ms/it, B1 {counts['B1'] / its[label]:.1f} per iteration")
        if len(set(its.values())) != 1:
            raise AssertionError(f"GMRES + ILU counts differ: {its}")
    finally:
        tdist.destroy_process_group()
    if tdist.is_initialized():
        raise AssertionError("the process group outlived phase 20")
    return out["dist"]["its"]


AIJ_GRID = 704  # phase 21: BASELINE config 4's grid, 991,232 rows of the Q1 operator


def _aij_launch(label, fn, want):
    """fn() with every kernel count set to 0 just before; the counts after
    must be exactly `want` ({name: launches}, the rest 0)."""
    _reset_counts()
    out = fn()
    counts = {k: v for k, v in _counts().items() if v}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return out


def _bits(label, kernel, plain, dtype):
    """A kernel launch against its plain version on the same inputs: held to
    TOL and to equal bits (B3 and B5 sum each row in the plain versions'
    order)."""
    _compare(f"{label} against its plain version", kernel, plain, dtype)
    if not torch.equal(kernel, plain):
        raise AssertionError(f"{label}: not bit-equal to its plain version")


def _aij_kernels(dev, mesh, card):
    """Phase 21 (a): the DistAIJ's products, per-rank ILU(0) and triplet
    exchange on the card."""
    n, f32 = AIJ_GRID, torch.float32
    csr, _, _, _ = poisson.assemble_poisson_csr(n - 1, n - 1, dtype=f32, device=dev)
    a = sparse.csr_to_scipy(csr)
    t0 = time.perf_counter()
    A = dist_csr.dist_aij_from_scipy(a, mesh, dtype=f32)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    Ae = dist_csr.dist_aij_from_scipy(a, mesh, dtype=f32, dia="off")
    kd, ndiag = A.diag_cols_t.shape[0], len(A.dia_offsets)
    if A.dia_data is None or A.has_ghosts or A.n_pad != a.shape[0]:
        raise AssertionError(f"704^2 DistAIJ: bands {A.dia_offsets}, ghosts {A.has_ghosts}, n_pad {A.n_pad}")
    print(f"  {n}^2 f32 DistAIJ: {A.n_pad} rows, {a.nnz} entries, kd {kd}, {ndiag} bands ({ndiag * A.n_pad} "
          f"band slots <= 2 x {a.nnz}: dia='auto' attaches them), ELL {2 * kd * A.n_pad * 4 / 1e6:.0f} MB, "
          f"bands {ndiag * A.n_pad * 4 / 1e6:.0f} MB, host plan {t_plan:.2f} s, ghost_count {A.ghost_count}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    x = torch.randn((A.n_pad,), generator=gen, dtype=f32, device=dev)
    ref = csr.matvec(x)
    y = _aij_launch("DistAIJ matvec, dia='auto'", lambda: A.matvec(x), {"B3": 1})
    _compare("DistAIJ matvec (B3) against the serial CSR matvec", y, ref, f32)
    _bits("B3 on the DistAIJ's bands", dia.dia_spmv_2d(A.dia_data, x, A.dia_offsets),
          dia.dia_spmv_plain(A.dia_data, x, A.dia_offsets), f32)
    y = _aij_launch("DistAIJ matvec, dia='off'", lambda: Ae.matvec(x), {"B5": 1})
    _compare("DistAIJ matvec (B5) against the serial CSR matvec", y, ref, f32)
    _bits("B5 on the DistAIJ's diag block", ell.ell_spmv(Ae.diag_cols_t, Ae.diag_vals_t, x),
          ell.ell_spmv_plain(Ae.diag_cols_t, Ae.diag_vals_t, x), f32)
    Ad, _ = sparse.csr_to_dia(csr)
    t = {label: _median_ms(fn) for label, fn in (("DistAIJ B3", lambda: A.matvec(x)),
                                                 ("DistAIJ B5", lambda: Ae.matvec(x)),
                                                 ("serial DIA B3", lambda: Ad.matvec(x)),
                                                 ("serial CSR", lambda: csr.matvec(x)))}
    print(f"  {n}^2 f32 matvec device time (median of 60, CUDA events): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in t.items()) + f" ({card})")

    # per-rank ILU(0): the card's factors and apply against the CPU build
    cpu_mesh = dataclasses.replace(mesh, device=torch.device("cpu"))
    t0 = time.perf_counter()
    M = dist_csr.dist_aij_ilu0(A, sweeps=6)
    torch.cuda.synchronize()
    t_ilu = time.perf_counter() - t0
    M_cpu = dist_csr.dist_aij_ilu0(dist_csr.dist_aij_from_scipy(a, cpu_mesh, dtype=f32), sweeps=6)
    for name in ("L_vals_t", "U_vals_t", "inv_diag"):
        if not torch.equal(getattr(M, name).cpu(), getattr(M_cpu, name)):
            raise AssertionError(f"DistAIJ ILU(0) {name}: the card's build differs from the CPU's")
    r = torch.randn((A.n_pad,), generator=gen, dtype=f32, device=dev)
    z = _aij_launch("DistAIJILU0PC apply", lambda: M(r), {"B5": 12})
    _compare("DistAIJILU0PC apply on the card against the CPU", z.cpu(), M_cpu(r.cpu()), f32)
    t_apply = _median_ms(lambda: M(r))
    print(f"  per-rank ILU(0): host factorization {t_ilu:.2f} s, factors equal to the CPU build's, 12 B5 "
          f"launches an apply, {t_apply * 1e3:.1f} us per apply (device, median of 60) ({card})")

    # matmat, k = 8: row-major and KSPMatSolve's transposed batch, one B6 each
    X = torch.randn((A.n_pad, 8), generator=gen, dtype=f32, device=dev)
    cols = torch.stack([A.matvec(X[:, c].contiguous()) for c in range(8)], dim=1)
    Y = _aij_launch("DistAIJ matmat, k = 8", lambda: A.matmat(X), {"B6": 1})
    _compare("DistAIJ matmat (B6) against 8 column matvecs (B3)", Y, cols, f32)
    XT = X.T.contiguous()
    Yb = _aij_launch("DistAIJ matmat_batch, k = 8", lambda: A.matmat_batch(XT), {"B6": 1})
    _compare("DistAIJ matmat_batch (B6) against 8 column matvecs (B3)", Yb.T, cols, f32)
    _compare("B6 on the DistAIJ's bands against its plain version", dia_spmm.dia_spmm(A.dia_data, X, A.dia_offsets),
             dia_spmm.dia_spmm_plain(A.dia_data, X, A.dia_offsets), f32)
    del A, Ae, Ad, M, M_cpu, csr, a

    # triplets on the card: duplicated and shuffled, against from_scipy
    f64 = torch.float64
    csr, _, _, _ = poisson.assemble_poisson_csr(256, 256, dtype=f64, device=dev)
    a = sparse.csr_to_scipy(csr).tocoo()
    rows = torch.tensor(np.concatenate([a.row, a.row]), dtype=torch.int64, device=dev)
    cols_ = torch.tensor(np.concatenate([a.col, a.col]), dtype=torch.int64, device=dev)
    vals = torch.tensor(np.concatenate([0.5 * a.data, 0.5 * a.data]), dtype=f64, device=dev)
    order = torch.randperm(rows.shape[0], generator=gen, device=dev)
    rows, cols_, vals = rows[order], cols_[order], vals[order]
    r_, c_, v_, overflow = dist_csr.exchange_triplets(rows, cols_, vals, mesh, a.shape[0], rows.shape[0])
    if not (r_.is_cuda and overflow.item() == 0 and torch.equal(r_, rows) and torch.equal(v_, vals)):
        raise AssertionError("exchange_triplets in a world of one moved or dropped triplets")
    t0 = time.perf_counter()
    Ac = dist_csr.dist_aij_from_coo(rows, cols_, vals, a.shape[0], mesh)
    torch.cuda.synchronize()
    t_coo = time.perf_counter() - t0
    As = dist_csr.dist_aij_from_scipy(sps.csr_matrix(a), mesh)
    for name in ("diag_cols_t", "diag_vals_t", "off_cols_t", "send_idx", "dia_data"):
        if not torch.equal(getattr(Ac, name), getattr(As, name)):
            raise AssertionError(f"dist_aij_from_coo's {name} differs from dist_aij_from_scipy's")
    print(f"  257^2 f64 dist_aij_from_coo on the card ({rows.shape[0]} triplets, each entry split in two and "
          f"shuffled): {t_coo:.2f} s, its plan equal to dist_aij_from_scipy's")
    x = torch.randn((As.n_pad,), generator=gen, dtype=f64, device=dev)
    y = _aij_launch("DistAIJ matvec, 257^2 f64", lambda: As.matvec(x), {"B3": 1})
    _compare("DistAIJ matvec (B3) against the serial CSR matvec", y, csr.matvec(x), f64)
    _bits("B3 on the DistAIJ's bands", dia.dia_spmv_2d(As.dia_data, x, As.dia_offsets),
          dia.dia_spmv_plain(As.dia_data, x, As.dia_offsets), f64)


def _true_rel_aij(run):
    """|f - A x| / |f| in f64 on the host, for an -mat_type aij run."""
    prob = run.problem
    A = prob.A
    a = (A.to_scipy() if isinstance(A, dist_csr.DistAIJ) else sparse.csr_to_scipy(A)).astype(np.float64)
    n = a.shape[0]
    f = prob.f.double().cpu().numpy()[:n]
    x = run.result.x.double().cpu().numpy()[:n]
    return float(np.linalg.norm(f - a @ x) / np.linalg.norm(f))


def phase_aij_dist(dev, tmp, card):
    """Phase 21: MATMPIAIJ in a world of one on NCCL."""
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(tmp, "nccl_store_aij"), 1), rank=0,
                             world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = dist_csr.make_mesh_1d()
        if tdist.get_backend() != "nccl" or mesh.device.type != "cuda":
            raise AssertionError(f"backend {tdist.get_backend()}, mesh on {mesh.device}")
        _aij_kernels(dev, mesh, card)

        n = AIJ_GRID
        common = ["-device", "cuda", "-mat_type", "aij", "-da_grid_x", str(n), "-da_grid_y", str(n), "-dtype", "f32",
                  "-ksp_type", "cg", "-ksp_rtol", "1e-5", "-ksp_converged_reason", "-log_view", "-no_vtk"]
        solves = {
            "CG + Jacobi": ({"dist": ["-dist", "-pc_type", "jacobi"], "serial": ["-pc_type", "jacobi"]},
                            {"dist": ("B3",), "serial": ()}),
            "CG + bjacobi/ILU(0)": ({"dist": ["-dist", "-pc_type", "bjacobi"], "serial": ["-pc_type", "ilu"]},
                                    {"dist": ("B3", "B5"), "serial": ()}),
        }
        for solve, (extra, kernels) in solves.items():
            out = {}
            # host-bound times vary between runs: dist, serial, serial, dist
            for label in ("dist", "serial", "serial", "dist"):
                run, counts = _cli(common + extra[label], kernels[label])
                res = run.result
                its = res.iterations
                t_asm, t_setup, t_solve = (run.log.phases[p].total_s for p in ("Assembly", "PCSetUp", "KSPSolve"))
                true_rel = _true_rel_aij(run)
                per = ", ".join(f"{k} {counts[k] / its:.2f}" for k in ("B3", "B5", "B6"))
                print(f"  {n}^2 f32 -mat_type aij {solve}, {label}: {its} its, {res.reason_name()}, Assembly "
                      f"{t_asm:.3f} s, PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, {t_solve / its * 1e3:.4f} "
                      f"ms/it, launches per iteration {per}, true residual {true_rel:.3e} (f64) ({card})")
                if (label == "dist") != isinstance(run.problem.A, dist_csr.DistAIJ):
                    raise AssertionError(f"{solve}, {label}: the run took the wrong route")
                if label in out and its != out[label]:
                    raise AssertionError(f"{solve}, {label}: {its} its, the first run took {out[label]}")
                # an f32 solution at this size leaves a floor near 0.05 (kappa(A) x f32's eps)
                if not true_rel < 1.0:
                    raise AssertionError(f"{solve}, {label}: true residual {true_rel}")
                out[label] = its
            print(f"  {solve} at world size 1: distributed {out['dist']} its, serial {out['serial']} its")
    finally:
        tdist.destroy_process_group()
    if tdist.is_initialized():
        raise AssertionError("the process group outlived phase 21")


GAMG_DIST_GRID = 1024  # phase 22: the JAX bench's gamg_* workload, 1,048,576 rows (bench.py:895-939)


def _poisson5(n, dtype):
    """The JAX bench's gamg matrix: the n^2 5-point operator with 4 on each
    1-D diagonal (bench.py:915-917)."""
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n))
    return (sps.kron(sps.identity(n), t) + sps.kron(t, sps.identity(n))).tocsr().astype(dtype)


def _dist_gamg_levels(M):
    """Each level of a DistAMGPC: rows and format (banded: B3; ELL: B5, with
    its width), then the coarse solve."""
    out = []
    for k, lvl in enumerate(M.levels):
        A = lvl.A
        fmt = (f"banded, B3, {len(A.dia_offsets)} bands" if A.dia_data is not None
               else f"ELL, B5, width {A.diag_cols_t.shape[0]}")
        out.append(f"level {k}: {A.shape[0]} rows ({fmt}), P and R ELL (B5) to {lvl.n_pad_c}")
    ci = M.coarse_inv
    split = f", {ci.iso.shape[0]} decoupled rows + dense {ci.rest.shape[0]}" if hasattr(ci, "iso") else ""
    out.append(f"coarse: {ci.shape[0]} rows, {type(ci).__name__}{split}")
    return "; ".join(out)


def _apply_launches(M):
    """The kernel launches of one DistAMGPC V-cycle in a world of one (no
    ghosts): on each level six level matvecs (two Chebyshev steps before
    and after, two residuals; B3 when banded, else B5) and one each of R
    and P (B5)."""
    want = {"B3": 0, "B5": 0}
    for lvl in M.levels:
        want["B3" if lvl.A.dia_data is not None else "B5"] += 6
        want["B5"] += 2
    return {k: v for k, v in want.items() if v}


def _gamg_bench(dev, mesh, card):
    """Phase 22 (a): the JAX bench's gamg workload, stream and global setups.
    Returns the stream run's launch counts and iterations."""
    n = GAMG_DIST_GRID
    a = _poisson5(n, np.float32)
    A = dist_csr.dist_aij_from_scipy(a, mesh)
    b = dist_csr.pad_vector(np.ones(a.shape[0], np.float32), A.n_pad, mesh)
    a64 = a.astype(np.float64)
    for setup in ("stream", "global"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M = amg.dist_amg_pc(A, setup=setup)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        t_solve = []
        # the first solve after a setup pays one-time costs; the second is
        # the JAX bench's warm gamg_solve_s
        for _ in range(2):
            _reset_counts()
            t0 = time.perf_counter()
            res = krylov.cg(A, b, M=M, rtol=1e-6, maxiter=100)
            torch.cuda.synchronize()
            t_solve.append(time.perf_counter() - t0)
        counts = _counts()
        its = res.iterations
        x = res.x.double().cpu().numpy()[: a.shape[0]]
        true_rel = float(np.linalg.norm(1.0 - a64 @ x) / np.sqrt(a.shape[0]))
        print(f"  {n}^2 f32 5-point ({a.shape[0]} rows) CG + dist gamg, setup={setup}: {its} its, "
              f"{res.reason_name()}, PCSetUp {t_setup:.3f} s, KSPSolve {t_solve[1]:.4f} s warm "
              f"({t_solve[1] / its * 1e3:.3f} ms/it; the first solve {t_solve[0]:.4f} s), launches per "
              f"iteration B3 {counts['B3'] / its:.2f}, B5 {counts['B5'] / its:.2f}, true residual {true_rel:.3e} "
              f"(f64) ({card})")
        print("    " + _dist_gamg_levels(M))
        # an f32 solution of a well-conditioned (diagonally dominant) system
        if res.reason_name() != "CONVERGED_RTOL" or not true_rel <= 1e-4:
            raise AssertionError(f"setup={setup}: {res.reason_name()}, true residual {true_rel}")
        if counts["B3"] < its or counts["B5"] < its:
            raise AssertionError(f"setup={setup}: B3 {counts['B3']}, B5 {counts['B5']} launches for {its} its")
        if setup == "stream":
            stream = counts, its
        del M
    return stream


def _gamg_cli(card):
    """Phase 22 (b): the CLI route -mat_type aij -dist -pc_type gamg at 704^2
    f64, both setups, beside the serial -mat_type aij -pc_type gamg."""
    n = AIJ_GRID
    common = ["-device", "cuda", "-mat_type", "aij", "-da_grid_x", str(n), "-da_grid_y", str(n), "-dtype", "f64",
              "-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8", "-ksp_norm_type", "unpreconditioned",
              "-ksp_converged_reason", "-log_view", "-no_vtk"]
    extra = {"dist global": ["-dist", "-pc_gamg_setup", "global"], "dist stream": ["-dist", "-pc_gamg_setup", "stream"],
             "serial": []}
    its = {}
    # host-bound times vary between runs: dist, serial, serial, dist
    for label in ("dist global", "dist stream", "serial", "serial", "dist stream", "dist global"):
        run, counts = _cli(common + extra[label], ("B3", "B5"))
        res, M = run.result, run.ksp.M
        t_asm, t_setup, t_solve = (run.log.phases[p].total_s for p in ("Assembly", "PCSetUp", "KSPSolve"))
        true_rel = _true_rel_aij(run)
        k = res.iterations
        print(f"  {n}^2 f64 -mat_type aij CG + gamg, {label}: {k} its, {res.reason_name()}, Assembly {t_asm:.3f} s, "
              f"PCSetUp {t_setup:.3f} s, KSPSolve {t_solve:.4f} s, {t_solve / k * 1e3:.4f} ms/it, launches in the "
              f"run B3 {counts['B3']}, B5 {counts['B5']} (the stream setup's power iterations among them), true "
              f"residual {true_rel:.3e} (f64) ({card})")
        if label in its:
            if k != its[label]:
                raise AssertionError(f"{label}: {k} its, the first run took {its[label]}")
        else:
            print("    " + (_dist_gamg_levels(M) if label != "serial" else
                            f"{len(M.levels)} levels, coarse {type(M.coarse_inv).__name__}"))
        if label.startswith("dist") != isinstance(run.problem.A, dist_csr.DistAIJ) or (
                label.startswith("dist") and type(M).__name__ != "DistAMGPC"):
            raise AssertionError(f"{label}: the run took the wrong route")
        if not true_rel <= 1e-6:
            raise AssertionError(f"{label}: true residual {true_rel} > 1e-6")
        its[label] = k
    print(f"  CG + gamg at 704^2 f64: dist global {its['dist global']}, dist stream {its['dist stream']}, serial "
          f"{its['serial']} its")
    if abs(its["dist global"] - its["serial"]) > 1 or abs(its["dist stream"] - its["dist global"]) > 1:
        raise AssertionError(f"gamg counts differ by more than 1: {its}")


def _gamg_apply(dev, mesh, card):
    """Phase 22 (c): one DistAMGPC apply at 1024^2 f64 (the streaming
    setup): exact launches, device time, and the CPU build's result."""
    a = _poisson5(GAMG_DIST_GRID, np.float64)
    A = dist_csr.dist_aij_from_scipy(a, mesh)
    M = amg.dist_amg_pc(A, setup="stream")
    cpu_mesh = dataclasses.replace(mesh, device=torch.device("cpu"))
    M_cpu = amg.dist_amg_pc(dist_csr.dist_aij_from_scipy(a, cpu_mesh), setup="stream")
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    r = torch.randn((A.n_pad,), generator=gen, dtype=torch.float64, device=dev)
    want = _apply_launches(M)
    z = _aij_launch("DistAMGPC apply", lambda: M(r), want)
    _compare("DistAMGPC apply on the card against the CPU build", z.cpu(), M_cpu(r.cpu()), torch.float64)
    t = _median_ms(lambda: M(r))
    print(f"  DistAMGPC apply, {GAMG_DIST_GRID}^2 f64, {len(M.levels)} levels: launches {want}, {t * 1e3:.1f} us "
          f"(device, median of 60, CUDA events), equal to the CPU build to 1e-12 of max|z| ({card})")


def phase_gamg_dist(dev, tmp, card):
    """Phase 22: the distributed gamg in a world of one on NCCL. Returns (a)'s
    streaming-setup launch counts and iterations."""
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(tmp, "nccl_store_gamg"), 1), rank=0,
                             world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = dist_csr.make_mesh_1d()
        if tdist.get_backend() != "nccl" or mesh.device.type != "cuda":
            raise AssertionError(f"backend {tdist.get_backend()}, mesh on {mesh.device}")
        counts, its = _gamg_bench(dev, mesh, card)
        _gamg_cli(card)
        _gamg_apply(dev, mesh, card)
        # (d) the twin of the JAX package's entry hooks
        out = graft_entry.dryrun_multichip(dev)
        step, operands = graft_entry.entry(dev)
        (u, _), rnorm = step(*operands)
        print(f"  graft_entry.dryrun_multichip() on NCCL, world of one: {out}; entry(): x {tuple(u.shape)} on "
              f"{u.device}, rnorm {rnorm:.3e}")
        if not (u.is_cuda and np.isfinite(rnorm)):
            raise AssertionError(f"entry(): x on {u.device}, rnorm {rnorm}")
    finally:
        tdist.destroy_process_group()
    if tdist.is_initialized():
        raise AssertionError("the process group outlived phase 22")
    return counts, its


MG_DIST_GRID = 1025  # phase 23 (a), (c): the grid of phases 15-16
CONFIG5_GRID = 2241  # phase 23 (d): BASELINE config 5, 10,044,166 KKT rows (bench.py:1240-1268)
# BASELINE config 5's solver: MINRES + Schur(diag) with the MG A-block (bench.py:514-527)
CONFIG5_PC = ["-ksp_type", "minres", "-pc_type", "fieldsplit", "-fieldsplit_inner_pc_type", "mg",
              "-pc_mg_smoother", "chebyshev", "-ksp_rtol", "1e-8"]


def _mg_levels(M):
    """The node grids of a DistMGPC: split over the ranks, then replicated,
    then the dense coarsest."""
    split = [lvl.A.grid_shape[0] for lvl in M.levels]
    tail = [lvl.A.grid_shape[0] for lvl in M.tail.levels]
    n_c = M.tail.coarse_inv.shape[0]
    return (f"levels {split} split over the ranks, {tail} replicated, coarsest {M.tiling.shape[0]}^2 nodes "
            f"gathered ({n_c} dofs, dense)")


def _dist_vs_serial(label, argv):
    """The CLI's -dist route beside the serial one, run dist, serial,
    serial, dist; the counts must be equal, and each route's two runs
    equal. Returns ({route: (CliRun, counts, best ms per iteration)},
    |x_dist - x_serial| / |x_serial|)."""
    out = {}
    for route in ("dist", "serial", "serial", "dist"):
        run, counts = _cli(argv + (["-dist"] if route == "dist" else []))
        t_setup, t_solve, ms = _phases(run)
        its = run.result.iterations
        print(f"  {label}, {route}: {its} its, {run.result.reason_name()}, PCSetUp {t_setup:.3f} s, KSPSolve "
              f"{t_solve:.4f} s, {ms:.4f} ms/it, B1 {counts['B1'] / its:.2f} per iteration")
        if route == "dist" and not isinstance(run.problem, cli.DistProblem):
            raise AssertionError(f"{label}: the -dist run did not take the distributed route")
        if route in out:
            if its != out[route][0].result.iterations:
                raise AssertionError(f"{label} {route}: {its} its, the first run took {out[route][0].result.iterations}")
            ms = min(ms, out[route][2])
        out[route] = (run, counts, ms)
    its = {route: v[0].result.iterations for route, v in out.items()}
    xd, xs = out["dist"][0].result.x, out["serial"][0].result.x
    dx = (krylov.tnorm(krylov.tsub(xd, xs)) / krylov.tnorm(xs)).item()
    print(f"  {label}: dist {its['dist']} its, serial {its['serial']} its, |x_dist - x_serial|/|x_serial| = "
          f"{dx:.3e}, ms/it (the faster of two runs) {out['dist'][2]:.4f} / {out['serial'][2]:.4f}")
    if its["dist"] != its["serial"]:
        raise AssertionError(f"{label}: the distributed and serial counts differ: {its}")
    return out, dx


def _vcycle_ms(M, r, reps=20):
    """Host milliseconds of one apply, over reps in a row (synchronized)."""
    M(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        M(r)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _dist_mg_poisson(dev, card):
    """Phase 23 (a): CG + MG at 1025^2 f64, -dist against serial, and one
    V-cycle of each."""
    n = MG_DIST_GRID
    argv = ["-device", "cuda", "-da_grid_x", str(n), "-da_grid_y", str(n), "-dtype", "f64", "-ksp_type", "cg",
            "-pc_type", "mg", "-ksp_rtol", "1e-8", "-ksp_converged_reason", "-log_view", "-no_vtk"]
    out, dx = _dist_vs_serial(f"{n}^2 f64 CG + MG (sor)", argv)
    if not dx <= 1e-12:
        raise AssertionError(f"{n}^2 CG + MG: |x_dist - x_serial|/|x_serial| = {dx}")
    Md, Ms = out["dist"][0].ksp.M, out["serial"][0].ksp.M
    print(f"  {n}^2 f64 mg_pc_dist: {_mg_levels(Md)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    r = torch.randn((2, n, n), generator=gen, dtype=torch.float64, device=dev)
    _reset_counts()
    zd = Md(r)
    torch.cuda.synchronize()
    launches, entries = _launches("B1"), _entry_launches()
    _compare("distributed V-cycle against the serial V-cycle", zd, Ms(r), torch.float64)
    ms_d, ms_s = _vcycle_ms(Md, r), _vcycle_ms(Ms, r)
    print(f"  {n}^2 f64 V-cycle (sor): {launches} B1 launches (local entry {entries['stencil_spmv']}, padded entry "
          f"{entries['stencil_spmv_padded']}), {ms_d:.3f} ms distributed, {ms_s:.3f} ms serial (host clock, 20 in a "
          f"row) ({card})")
    if launches < 2 * len(Md.levels):
        raise AssertionError(f"{launches} B1 launches in a V-cycle of {len(Md.levels)} distributed levels")


def _config5(dev, card):
    """Phase 23 (d): BASELINE config 5's solver at 2241^2 through the CLI.
    Returns its B1, FE and RN launches (one FE launch: one rank, one
    assembly; one RN launch a Chebyshev level), iterations and KSPSolve
    seconds."""
    n = CONFIG5_GRID
    argv = ["-device", "cuda", "-problem_type", "saddle", "-dist", "-da_grid_x", str(n), "-da_grid_y", str(n),
            "-dtype", "f64", "-body_force", "trig"] + CONFIG5_PC + ["-ksp_converged_reason", "-log_view", "-no_vtk"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    run, counts = _cli(argv)
    peak = torch.cuda.max_memory_allocated(dev)
    res, prob, M = run.result, run.problem, run.ksp.M.inner_solve
    its = res.iterations
    t_asm, t_setup, t_solve = (run.log.phases[p].total_s for p in ("Assembly", "PCSetUp", "KSPSolve"))
    rows = prob.A.n + prob.Bf.shape[0]
    true_rel = dist_probe.true_rel_kkt(prob.A.planes, prob.Bf, prob.rhs, res.x)
    print(f"  config 5, {n}^2 f64 ({rows} KKT rows), MINRES + Schur(diag, MG chebyshev), -dist world of one: {its} its, "
          f"{res.reason_name()} (reason {res.converged_reason}), Assembly {t_asm:.3f} s, PCSetUp {t_setup:.3f} s, "
          f"KSPSolve {t_solve:.4f} s, {t_solve / its * 1e3:.4f} ms/it, B1 {counts['B1']} launches "
          f"({counts['B1'] / its:.2f} per iteration), true residual {true_rel:.3e} (f64), peak device memory "
          f"{peak / 2**30:.2f} GiB ({card})")
    print(f"  config 5 {_mg_levels(M)}")
    if type(M).__name__ != "DistMGPC" or rows != 10_044_166:
        raise AssertionError(f"config 5: A-block {type(M).__name__}, {rows} rows")
    if counts["FE"] != 1:
        raise AssertionError(f"config 5: {counts['FE']} FE launches for one rank's one assembly")
    rn = _launches("RN")
    if rn != len(M.levels):
        raise AssertionError(f"config 5: {rn} RN launches for {len(M.levels)} Chebyshev levels")
    if res.converged_reason <= 0 or not np.isfinite(true_rel):
        raise AssertionError(f"config 5: {res.reason_name()}, true residual {true_rel}")
    # B1 at every split level's grid, against its plain version
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for lvl in M.levels:
        planes = lvl.A.planes
        x = torch.randn((2, *planes.shape[-2:]), generator=gen, dtype=planes.dtype, device=dev)
        _compare(f"B1  config 5 level grid {planes.shape[-1]}^2 f64", spmv.stencil_spmv(planes, x),
                 spmv.planes_matvec_field(planes, x), torch.float64)
    return {"B1": counts["B1"], "FE": counts["FE"], "RN": rn, "its": its, "solve_s": t_solve}


def phase_mg_dist(dev, tmp, card):
    """Phase 23: the distributed SOR, fieldsplit and MG in a world of one on
    NCCL. Returns config 5's B1 launches, iterations and KSPSolve seconds."""
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(tmp, "nccl_store_mg"), 1), rank=0,
                             world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=300))
    try:
        if tdist.get_backend() != "nccl":
            raise AssertionError(f"backend {tdist.get_backend()}, not nccl")
        t0 = time.perf_counter()
        _dist_mg_poisson(dev, card)
        print(f"phase 23 (a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        g257 = ["-device", "cuda", "-da_grid_x", "257", "-da_grid_y", "257", "-dtype", "f64", "-ksp_rtol", "1e-8",
                "-ksp_max_it", "20000", "-ksp_converged_reason", "-log_view", "-no_vtk"]
        _dist_vs_serial("257^2 f64 CG + sor", g257 + ["-ksp_type", "cg", "-pc_type", "sor"])
        _dist_vs_serial("257^2 f64 GMRES + fieldsplit (multiplicative)",
                        g257 + ["-ksp_type", "gmres", "-pc_type", "fieldsplit", "-pc_fieldsplit_type", "multiplicative"])
        print(f"phase 23 (b): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        n = MG_DIST_GRID
        kkt = ["-device", "cuda", "-problem_type", "saddle", "-da_grid_x", str(n), "-da_grid_y", str(n), "-dtype",
               "f64", "-body_force", "trig", "-ksp_converged_reason", "-log_view", "-no_vtk"] + CONFIG5_PC
        _dist_vs_serial(f"{n}^2 f64 saddle MINRES + Schur(diag, MG chebyshev)", kkt)
        print(f"phase 23 (c): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        config5 = _config5(dev, card)
        print(f"phase 23 (d): {time.perf_counter() - t0:.1f} s")
    finally:
        tdist.destroy_process_group()
    if tdist.is_initialized():
        raise AssertionError("the process group outlived phase 23")
    return config5


REFINE_DIST_GRID = 705  # phase 24 (a): the JAX bench's kkt_rtol1e8_dist, 994,054 KKT rows (bench.py:407, :1164)


def _refined_dist(dev, mesh, n, inner, inner_maxiter, card):
    """One refinement of phase 24: the n^2 trig KKT system assembled in
    f64 on the mesh, its f32 copy and the inner PC built once (PCSetUp),
    then solve_refined_kkt_fused to rtol 1e-8 with inner rtol 1e-3, every
    kernel count set to 0 just before. Returns the f64 system, x, and a
    dict of the numbers printed."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    K, rhs, _ = pdist.assemble_saddle_dist(pdist.DistGrid.create(n - 1, n - 1, mesh), body_force="trig")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    K32 = refine.kkt_f32(K)
    kw = refine.refine_inner(K32, inner)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    x, cycles, its, rn, rn0 = refine.solve_refined_kkt_fused(K32, rhs, planes_df=K.A.planes, Bf_df=K.Bf,
                                                             inner_rtol=1e-3, inner_maxiter=inner_maxiter, **kw)()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    b1 = _dtype_launches()
    fe = _launches("FE")
    peak = torch.cuda.max_memory_allocated(dev)
    # independent of refine.py: the plain serial f64 matvec on the (here
    # trivially) gathered patch
    planes, Bf, f, u = (pmesh.gather_field(t, mesh) for t in (K.A.planes, K.Bf, rhs[0], x[0]))
    true_rel = dist_probe.true_rel_kkt(planes, Bf, (f, rhs[1]), (u, x[1]), (n, n))
    rows = n * n * 2 + K.Bf.shape[0]
    out = {"cycles": cycles, "its": its, "reason": "CONVERGED_RTOL" if rn <= 1e-8 * rn0 else "DIVERGED_ITS",
           "asm_s": t1 - t0, "setup_s": t2 - t1, "solve_s": t3 - t2, "b1": b1, "fe": fe, "peak": peak,
           "true_rel": true_rel}
    print(f"  {n}^2 ({rows} KKT rows) refinement, f64 residual, f32 {inner} inner, -dist world of one: {cycles} "
          f"cycles, {its} inner its, {out['reason']}, Assembly {out['asm_s']:.3f} s, PCSetUp {out['setup_s']:.3f} s, "
          f"solve {out['solve_s']:.4f} s, B1 launches {b1[torch.float32]} f32 (inner) and {b1[torch.float64]} f64 "
          f"(residual), |r|/|b| {rn / rn0:.3e} (loop), true relative residual {true_rel:.3e} (f64, plain), peak "
          f"device memory {peak / 2**30:.2f} GiB ({card})")
    if x[0].dtype != torch.float64 or b1[torch.float32] < its or b1[torch.float64] < cycles + 1 or fe != 1:
        raise AssertionError(f"refinement at {n}^2: x {x[0].dtype}, B1 launches {b1} for {its} inner its, "
                             f"{cycles} cycles, {fe} FE launches for one assembly")
    if out["reason"] != "CONVERGED_RTOL" or not true_rel <= 1e-8:
        raise AssertionError(f"refinement at {n}^2: {out['reason']}, true residual {true_rel}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    for dtype in (torch.float32, torch.float64):
        planes = K.A.planes.to(dtype)
        v = torch.randn(x[0].shape, generator=gen, dtype=dtype, device=dev)
        _compare(f"B1  phase 24 grid {n}^2", spmv.stencil_spmv(planes, v), spmv.planes_matvec_field(planes, v), dtype)
    return K, rhs, x, out


def phase_refine_dist(dev, tmp, card, config5):
    """Phase 24: the JAX bench's distributed refinement
    (`bench_refined_kkt_dist`) in a world of one on NCCL: (a) its
    kkt_rtol1e8_dist setting beside the serial refinement of the same
    system, (b) config 5 beside phase 23 (d)'s direct f64 MINRES. Returns
    the B1 and the FE launches of (a) and (b), and their (cycles, inner
    iterations)."""
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(tmp, "nccl_store_refine"), 1), rank=0,
                             world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=300))
    try:
        if tdist.get_backend() != "nccl":
            raise AssertionError(f"backend {tdist.get_backend()}, not nccl")
        mesh = pmesh.ProcessMesh.create(device=dev)
        t0 = time.perf_counter()
        n = REFINE_DIST_GRID
        K, rhs, xd, a = _refined_dist(dev, mesh, n, "minres-diag", 6000, card)
        # the serial refinement of the same arrays: a world of one is the serial route
        Ks = SaddleOperator(StencilOperator(K.A.planes), K.Bf)
        Ks32 = refine.kkt_f32(Ks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        xs, cycles, its, rn, rn0 = refine.solve_refined_kkt_fused(Ks32, rhs, planes_df=Ks.A.planes, Bf_df=Ks.Bf,
                                                                  inner_rtol=1e-3, inner_maxiter=6000,
                                                                  **refine.refine_inner(Ks32, "minres-diag"))()
        torch.cuda.synchronize()
        t_serial = time.perf_counter() - t1
        same = all(torch.equal(p, q) for p, q in zip(xd, xs))
        print(f"  {n}^2 serial refinement of the same system: {cycles} cycles, {its} inner its, PCSetUp + solve "
              f"{t_serial:.4f} s; x bit-equal to the -dist run: {same}")
        if (cycles, its) != (a["cycles"], a["its"]) or not same:
            raise AssertionError(f"{n}^2: -dist {a['cycles']} cycles, {a['its']} its; serial {cycles}, {its}; "
                                 f"x equal {same}")
        del K, rhs, xd, xs, Ks, Ks32
        print(f"phase 24 (a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        *_, b = _refined_dist(dev, mesh, CONFIG5_GRID, "minres-mg", 20000, card)
        print(f"  config 5, {CONFIG5_GRID}^2: refined {b['solve_s']:.4f} s ({b['cycles']} cycles, {b['its']} f32 inner "
              f"its); phase 23 (d)'s direct f64 MINRES KSPSolve {config5['solve_s']:.4f} s ({config5['its']} its); "
              f"ratio direct/refined {config5['solve_s'] / b['solve_s']:.2f} ({card})")
        print(f"phase 24 (b): {time.perf_counter() - t0:.1f} s")
    finally:
        tdist.destroy_process_group()
    if tdist.is_initialized():
        raise AssertionError("the process group outlived phase 24")
    counts = {"kkt_rtol1e8_dist": (a["cycles"], a["its"]), "config5": (b["cycles"], b["its"])}
    return sum(r["b1"][dtype] for r in (a, b) for dtype in r["b1"]), a["fe"] + b["fe"], counts


SCRIPT_LIMIT_S = 1200  # the time this script is given, builds included
# one key of each section the bench must have run, by section
BENCH_GROUPS = {
    "spmv": "spmv_pallas_nnz_per_s", "kkt_solve": "kkt_solve_s", "kkt_rtol1e8": "kkt_rtol1e8_s",
    "kkt_rtol1e8_dist": "kkt_rtol1e8_dist_s", "aij_tpu": "aij_tpu_nnz_per_s", "gamg": "gamg_its",
    "config2": "config2_rtol1e8_s", "config3": "config3_iterations", "config4": "config4_iterations",
    "config3_rtol1e8": "config3_rtol1e8_s", "scaling": "scaling_efficiency", "config5": "config5_s",
    "spmm": "spmm_nnz_per_s",
}


def phase_bench(tmp, card, t_start, counts):
    """Phase 25: `python -m saddle_point_petsc_tpu_torch.bench` at its full
    sizes in a subprocess, with BENCH_DEADLINE_S what is left of the
    script's time. Fails on a non-zero exit, a line over 1900 bytes, an
    errors key or a deadline hit, a missing key group, a line without
    `device` or `scaling_backend`, vs_baseline over
    1.05, a refined relative residual over 1e-8, and a count that differs
    from this run's phase: `counts` (config4_iterations from phase 20's
    -dist run, gamg_its from phase 22 (a), the kkt_rtol1e8_dist_* and
    config5_* cycles and inner iterations from phase 24)."""
    torch.cuda.empty_cache()
    left = SCRIPT_LIMIT_S - (time.perf_counter() - t_start) - 60
    full = os.path.join(tmp, "bench_full.json")
    env = dict(os.environ, BENCH_DEADLINE_S=str(int(left)), BENCH_FULL_PATH=full)
    env.pop("BENCH_CPU", None)
    run = subprocess.run([sys.executable, "-m", "saddle_point_petsc_tpu_torch.bench"], capture_output=True, text=True,
                         env=env, timeout=left + 30)
    print(run.stderr.strip())
    line = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    print(f"  bench line ({len(line.encode())} bytes, exit {run.returncode}): {line}")
    if run.returncode != 0 or len(line.encode()) > 1900:
        raise AssertionError(f"the bench exited {run.returncode} with a line of {len(line.encode())} bytes")
    compact = json.loads(line)
    with open(full) as fh:
        out = json.load(fh)
    if "errors" in compact or "bench_deadline_hit_s" in compact:
        raise AssertionError(f"the bench line has errors {compact.get('errors')}, deadline "
                             f"{compact.get('bench_deadline_hit_s')}")
    missing = [g for g, k in BENCH_GROUPS.items() if k not in out]
    missing += [k for k in ("device", "scaling_backend") if k not in compact]
    if missing:
        raise AssertionError(f"the bench lacks the key groups or line keys {missing}")
    if not out["vs_baseline"] <= 1.05:
        raise AssertionError(f"vs_baseline {out['vs_baseline']} over 1.05 of the copy's roofline")
    rel = {k: out[k] for k in ("kkt_rtol1e8_rel_rnorm", "kkt_rtol1e8_dist_rel_rnorm", "config5_rel_rnorm",
                                "config2_rtol1e8_rel_rnorm", "config3_rtol1e8_rel_rnorm")}
    if not all(v <= 1e-8 for v in rel.values()) or not out["scaling_matvec_max_err"] <= 1e-12:
        raise AssertionError(f"refined relative residuals {rel}, scaling product error {out['scaling_matvec_max_err']}")
    differ = {k: (out[k], v) for k, v in counts.items() if out[k] != v}
    print(f"  bench against this run's phases: {counts}; differing {differ} ({card})")
    if differ:
        raise AssertionError(f"bench counts differ from this run's phases (bench, phase): {differ}")
    print(f"  spmv {out['value']:.4g} nnz/s ({out['spmv_ms']:.4f} ms), vs_baseline {out['vs_baseline']:.4f} of "
          f"{out['roofline_bytes_per_s'] / 1e12:.4f} TB/s (copy); scaling {out['scaling_efficiency']:.4f} "
          f"({out['scaling_backend']}); {card}")


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

    t0 = time.perf_counter()
    for name, info in _build.build_all().items():
        print(f"build {name}: {info.seconds:.2f} s, {info.path}")
        print("  " + " ".join(info.command) if info.command else "  (loaded an existing build)")
        print(info.log.strip())
    print(f"all builds: {time.perf_counter() - t0:.2f} s")

    max_err, timings = phase_kernel(dev, card)
    rn_ulp, rn_timings = phase_rn(dev, card)
    t0 = time.perf_counter()
    fe_err, fe_timings = phase_fe(dev, card)
    print(f"phase 26: {time.perf_counter() - t0:.1f} s ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        launches, minres_f64 = phase_f64(tmp)
        minres_f32 = phase_f32(tmp)
        sparse_err, sparse_timings = phase_sparse_kernels(dev, card)
        phase_formats(tmp)
        gamg_counts, level_err, gamg_run = phase_gamg(dev)
        b4_launches, jacobi_1025 = phase_bdia_full()
        phase_saddle_gamg()
        spmm_err, spmm_timings = phase_spmm_kernels(dev, card, gamg_run)
        b2_launches = phase_mat_solve_stencil(dev)
        phase_mat_solve_dia(dev, gamg_run)
        b6_launches = phase_mat_solve_dia_f32(dev, gamg_run, spmm_timings["B6", torch.float32]["ms"])
        del gamg_run
        phase_mg(dev)
        phase_saddle_mg(minres_f32[1025])
        phase_refine(dev, minres_f64)
        phase_sweep()
        t0 = time.perf_counter()
        phase_ilu(dev, tmp, jacobi_1025)
        print(f"phase 19: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        config4_its = phase_dist(dev, tmp, card)
        print(f"phase 20: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_aij_dist(dev, tmp, card)
        print(f"phase 21: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dist_gamg_counts, gamg_its = phase_gamg_dist(dev, tmp, card)
        print(f"phase 22: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        config5 = phase_mg_dist(dev, tmp, card)
        print(f"phase 23: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        refine_launches, refine_fe, refined = phase_refine_dist(dev, tmp, card, config5)
        print(f"phase 24: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        phase_bench(tmp, card, t_start, {"config4_iterations": config4_its, "gamg_its": gamg_its, **{
            f"{key}_{name}": v for key, pair in refined.items() for name, v in zip(("cycles", "inner_its"), pair)}})
        print(f"phase 25: {time.perf_counter() - t0:.1f} s ({card})")
        # phase 4's saddle route, phase 23's config 5 and phase 24's refinements
        launches += config5["B1"] + refine_launches

    def row(name, source, replaces, launches, err, numbers):
        return {
            "name": name, "route": "cuda",
            "source": f"saddle_point_petsc_tpu_torch/csrc/{source}",
            "replaces": f"saddle_point_petsc_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": err, **numbers,
        }

    # phase 8's CG + gamg and phase 22's CG + distributed gamg (stream)
    b3_launches = gamg_counts["B3"] + dist_gamg_counts["B3"]
    b5_launches = gamg_counts["B5"] + dist_gamg_counts["B5"]
    b3_err = max(sparse_err["B3"], level_err["B3"])
    b5_err = max(spmm_err["B5"], level_err["B5"])
    # the -dist route's assemblies: phase 23 (d)'s config 5 and phase 24's two
    fe_launches = config5["FE"] + refine_fe
    f32 = torch.float32
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # B3 and B3' are one kernel under two entry names: its launches count both
    print(json.dumps({"kernels": [
        row("stencil_spmv (B1)", "stencil_spmv.cu", "spmv.py:44", launches, max_err, timings[f32]),
        row("dia_spmv_2d (B3)", "dia_spmv.cu", "spmv.py:215", b3_launches, b3_err,
            sparse_timings["B3", f32]),
        row("dia_spmv (B3', the same kernel)", "dia_spmv.cu", "spmv.py:463", b3_launches, b3_err,
            sparse_timings["B3'", f32]),
        row("bdia_spmv_2d (B4)", "bdia_spmv.cu", "spmv.py:335", b4_launches, sparse_err["B4"],
            sparse_timings["B4", f32]),
        row("stencil_spmm (B2)", "stencil_spmm.cu", "spmm.py:30", b2_launches, spmm_err["B2"],
            spmm_timings["B2", f32]),
        row("ell_spmv (B5)", "ell_spmv.cu", "spmv.py:150", b5_launches, b5_err,
            spmm_timings["B5", f32]),
        row("dia_spmm (B6)", "dia_spmm.cu", "spmm.py:97", b6_launches, spmm_err["B6"],
            spmm_timings["B6", f32]),
        {"name": "q1_assembly (FE), 2241^2 f64", "route": "cuda",
         "source": "saddle_point_petsc_tpu_torch/csrc/q1_assembly.cu",
         "replaces": "none (XLA einsums of saddle_point_petsc_tpu/parallel/dist.py)",
         "launches": fe_launches, "max_abs_err": fe_err, **fe_timings[torch.float64]},
        {"name": "normal_draw (RN), config 5's six levels f64", "route": "cuda",
         "source": "saddle_point_petsc_tpu_torch/csrc/normal_draw.cu",
         "replaces": "none (jax.random.normal of saddle_point_petsc_tpu/solvers/precond.py)",
         "launches": config5["RN"], "max_ulp": rn_ulp, **rn_timings},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
