"""CLI entry point (PyTorch twin of `saddle_point_petsc_tpu.cli`).

    python -m saddle_point_petsc_tpu_torch.cli -device cuda \
        -problem_type saddle -body_force trig -da_grid_x 257 -da_grid_y 257 \
        -ksp_rtol 1e-5 -ksp_converged_reason -log_view
    python -m saddle_point_petsc_tpu_torch.cli -da_grid_x 257 -da_grid_y 257 \
        -ksp_type cg -pc_type mg -ksp_rtol 1e-8 -ksp_converged_reason

Flags follow the JAX CLI and PETSc:
  -device {cuda,cpu}              where to assemble and solve [cuda]; cuda
                                  without a CUDA device raises
  -use_cpu                        the same as -device cpu
  -dtype {f32,f64}                [f64 on the CPU, f32 on a CUDA device]
  -da_grid_x/-da_grid_y <nodes>   grid node counts [4, i.e. 3x3 elements]
  -problem_type {poisson,saddle}  poisson = vector Laplace (GMRES/Jacobi by
                                  default); saddle = full KKT system
                                  (MINRES/Schur fieldsplit by default)
  -body_force {constant,trig}     (the stencil routes; aij/dia/bdia take
                                  the constant force, as in the JAX CLI)
  -mat_type {stencil,aij,dia,bdia} Poisson operator storage: stencil
                                  planes [default], general-sparse CSR
                                  (MATAIJ), banded DIA (kernel B3) or 2x2
                                  block-DIA (kernel B4); no effect on the
                                  saddle route
  -ksp_type/-pc_type/-ksp_rtol/-ksp_atol/-ksp_max_it/-ksp_monitor
  -ksp_converged_reason           (see solvers/ksp.py for the full set:
                                  every serial KSP and PC type of the JAX
                                  package, with -pc_type mg, gamg, ilu
                                  (-pc_ilu_sweeps) and
                                  -fieldsplit_inner_ksp_type)
  -A_mat_view -f_vec_view -solution_view     object viewers
  -vtk <path>                     VTK output file [test.vtk]
  -no_vtk                         skip VTK output
  -log_view                       phase timing report
  -profile <dir>                  torch.profiler trace of the KSPSolve
                                  phase (CPU activity, and CUDA activity
                                  on the card) as a Chrome trace in <dir>
  -options_left                   warn about unused options

-dist (with or without -mat_type) and -mesh belong to later slices of the
port and raise NotImplementedError. -mat_stencil_backend,
-mat_dia_backend and -mat_bdia_backend are not read: a tensor's device
picks plain version or kernel, and -options_left reports them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any

import torch

from saddle_point_petsc_tpu_torch.models import poisson, saddle
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.stencil import flat_to_field
from saddle_point_petsc_tpu_torch.solvers.krylov import KrylovResult
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.utils import monitor, viewers, vtk
from saddle_point_petsc_tpu_torch.utils.device import resolve_device
from saddle_point_petsc_tpu_torch.utils.options import Options

_DTYPES = {"f32": torch.float32, "f64": torch.float64}


@dataclasses.dataclass
class CliRun:
    """What one CLI run produced: exit code, solve result, problem, solver, timers."""

    rc: int
    result: KrylovResult
    problem: Any  # PoissonProblem, SaddleProblem or AijProblem
    ksp: KSP
    log: monitor.LogView


def _device(opts):
    name = opts.get_str("device", "cuda")
    if opts.get_bool("use_cpu"):  # the JAX CLI's flag for the CPU
        name = "cpu"
    if name != "cpu" and name.split(":")[0] != "cuda":
        raise ValueError(f"-device {name}: use cuda or cpu")
    return resolve_device(name)


@dataclasses.dataclass(frozen=True)
class AijProblem:
    """The Poisson system of the -mat_type aij|dia|bdia route: A a CSR, DIA
    or BDIA operator, f the flat interleaved right-hand side, bc_mask the
    (n,) eliminated rows, coords (ny, nx, 2)."""

    A: Any
    f: torch.Tensor
    bc_mask: torch.Tensor
    coords: torch.Tensor


def _refuse_later_slices(opts):
    if opts.get_bool("dist") or opts.has("mesh"):
        raise NotImplementedError(
            "-dist/-mesh: the distributed operators (and MATMPIAIJ for "
            "-mat_type aij -dist) are ROADMAP.md A.18-A.24"
        )


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """torch.profiler around the block (CPU activity, and CUDA activity on
    the card), written as a Chrome trace into trace_dir; nothing when
    trace_dir is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "kspsolve.pt.trace.json"))


def run(argv=None) -> CliRun:
    """Parse argv, assemble, solve, write outputs; return the whole run."""
    opts = Options(sys.argv[1:] if argv is None else argv)
    device = _device(opts)
    dtype_str = opts.get_str("dtype", "f64" if device.type == "cpu" else "f32")
    if dtype_str not in _DTYPES:
        raise ValueError(f"-dtype {dtype_str}: use f32 or f64")
    dtype = _DTYPES[dtype_str]
    _refuse_later_slices(opts)
    log = monitor.LogView()

    mx = opts.get_int("da_grid_x", 4)
    my = opts.get_int("da_grid_y", 4)
    nex, ney = mx - 1, my - 1
    problem_type = opts.get_str("problem_type", "poisson")
    if problem_type not in ("poisson", "saddle"):
        raise ValueError(f"-problem_type {problem_type}: use poisson or saddle")
    body_force = opts.get_str("body_force", "constant")
    mat_type = opts.get_str("mat_type", "stencil")
    aij_n = None  # rows of the flat -mat_type aij|dia|bdia solution
    with log.phase("Assembly"):
        if mat_type in ("aij", "dia", "bdia") and problem_type == "poisson":
            # MATAIJ route: the same system through the general sparse layer
            csr, f_flat, mask, coords = poisson.assemble_poisson_csr(
                nex, ney, dtype=dtype, device=device
            )
            aij_n = csr.shape[0]
            if mat_type == "dia":
                A, _ = sparse.csr_to_dia(csr)
            elif mat_type == "bdia":  # 2x2 blocks: the dof-interleaved layout
                A = sparse.bsr_to_bdia(sparse.csr_to_bsr(csr, block=2))
            else:
                A = csr
            b = f_flat
            prob = AijProblem(A, f_flat, mask, coords)
        elif problem_type == "saddle":
            prob = saddle.assemble_saddle(nex, ney, dtype=dtype, device=device, body_force=body_force)
            A, b = prob.K, prob.rhs
        else:
            prob = poisson.assemble_poisson(nex, ney, dtype=dtype, device=device, body_force=body_force)
            A, b = prob.A, prob.f
        monitor.synchronize(prob.f)

    viewers.view_from_options(prob.A, opts, "A_mat_view", "A")
    viewers.view_from_options(prob.f, opts, "f_vec_view", "f")

    # float32 products in full float32, as the JAX package's HIGHEST
    # precision contractions (B u, B^T lam, Schur setup)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ksp = KSP(opts)
    if problem_type == "saddle":
        ksp.ksp_type, ksp.pc_type = "minres", "fieldsplit"
    ksp.set_operators(A).set_from_options()
    with log.phase("PCSetUp"):
        ksp.set_up()
        monitor.synchronize(prob.f)  # waits for the whole device
    with _profiled(opts.get_str("profile", ""), device), log.phase("KSPSolve"):
        res = ksp.solve(b)
        monitor.synchronize(res.x)

    its = res.iterations
    # credit SpMV traffic to the solve phase for the nnz/s report
    st = log.phases["KSPSolve"]
    st.nnz_processed += float(prob.A.nnz) * max(its, 1)
    st.flops += 2.0 * float(prob.A.nnz) * max(its, 1)
    print(
        f"{problem_type}: grid {mx}x{my} nodes, ksp={ksp.ksp_type} "
        f"pc={ksp.pc_type}, its={its}, reason={res.reason_name()}, "
        f"rnorm={float(res.rnorm):.6e}"
    )

    u = res.x[0] if problem_type == "saddle" else res.x
    viewers.view_from_options(u, opts, "solution_view", "u")
    if not opts.get_bool("no_vtk"):
        with log.phase("WriteVTK"):
            if aij_n is not None:  # flat MATAIJ solution -> field
                u = flat_to_field(u[:aij_n], my, mx)
            vtk.write_vtk(opts.get_str("vtk", "test.vtk"), prob.coords, u)

    if opts.get_bool("log_view"):
        log.report()
    if opts.get_bool("options_left"):
        for name in opts.unused():
            print(f"WARNING! unused option: -{name}", file=sys.stderr)
    return CliRun(0 if res.converged_reason > 0 else 1, res, prob, ksp, log)


def main(argv=None):
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
