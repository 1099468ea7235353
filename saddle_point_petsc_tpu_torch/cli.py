"""CLI entry point (PyTorch twin of `saddle_point_petsc_tpu.cli`).

    python -m saddle_point_petsc_tpu_torch.cli -device cuda \
        -problem_type saddle -body_force trig -da_grid_x 257 -da_grid_y 257 \
        -ksp_rtol 1e-5 -ksp_converged_reason -log_view
    python -m saddle_point_petsc_tpu_torch.cli -da_grid_x 257 -da_grid_y 257 \
        -ksp_type cg -pc_type mg -ksp_rtol 1e-8 -ksp_converged_reason
    torchrun --nproc_per_node 4 -m saddle_point_petsc_tpu_torch.cli -dist \
        -problem_type saddle -da_grid_x 704 -da_grid_y 704 -body_force trig \
        -fieldsplit_inner_pc_type bjacobi -sub_pc_type chebyshev \
        -pc_bjacobi_local_its 4 -ksp_converged_reason
    torchrun --nproc_per_node 4 -m saddle_point_petsc_tpu_torch.cli -dist \
        -mat_type aij -da_grid_x 704 -da_grid_y 704 -ksp_type cg \
        -pc_type bjacobi -ksp_converged_reason

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
  -dist                           distribute over the ranks of the
                                  process group: the stencil routes by
                                  SPMD assembly and halo-exchange SpMV;
                                  -mat_type aij|dia|bdia as a DistAIJ
                                  (MATMPIAIJ, parallel/dist_csr.py) whose
                                  rows are partitioned over a 1-D mesh of
                                  every rank, with an all_to_all ghost
                                  scatter; all_reduce reductions. Under
                                  torchrun every rank joins the env://
                                  world (one rank per device,
                                  cuda:LOCAL_RANK); without it the process
                                  is a world of one. NCCL on CUDA, gloo on
                                  the CPU. Rank 0 alone prints and writes
                                  the VTK file
  -mesh <py,px>                   the process mesh of the stencil routes'
                                  -dist [PETSC_DECIDE near-square
                                  factorization of the world]; not read
                                  by -mat_type aij|dia|bdia
  -ksp_type/-pc_type/-ksp_rtol/-ksp_atol/-ksp_max_it/-ksp_monitor
  -ksp_converged_reason           (see solvers/ksp.py for the full set:
                                  every serial KSP and PC type of the JAX
                                  package, with -pc_type mg, gamg, ilu
                                  (-pc_ilu_sweeps) and
                                  -fieldsplit_inner_ksp_type)
  -A_mat_view -f_vec_view -solution_view     object viewers
  -vtk <path>                     VTK output file [test.vtk]
  -no_vtk                         skip VTK output
  -log_view                       phase timing report, with each phase's
                                  kernel launches, messages and all_reduces
  -profile <dir>                  torch.profiler trace of the KSPSolve
                                  phase (CPU activity, and CUDA activity
                                  on the card) as a Chrome trace in <dir>,
                                  with the program's spans (MatMult,
                                  PCApply, MGSmooth L0, ...)
  -options_left                   warn about unused options

-mat_stencil_backend,
-mat_dia_backend and -mat_bdia_backend are not read: a tensor's device
picks plain version or kernel, and -options_left reports them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import sys
from typing import Any

import torch
import torch.distributed as dist

from saddle_point_petsc_tpu_torch.models import fem, poisson, saddle
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.stencil import flat_to_field
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import dist_csr
from saddle_point_petsc_tpu_torch.parallel.mesh import ProcessMesh, gather_field, gather_rows, init_from_env
from saddle_point_petsc_tpu_torch.solvers.krylov import KrylovResult
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.utils import monitor, viewers, vtk
from saddle_point_petsc_tpu_torch.utils.device import resolve_device
from saddle_point_petsc_tpu_torch.utils.options import Options

_DTYPES = {"f32": torch.float32, "f64": torch.float64}
_AIJ_TYPES = ("aij", "dia", "bdia")


@dataclasses.dataclass
class CliRun:
    """What one CLI run produced: exit code, solve result, problem, solver, timers."""

    rc: int
    result: KrylovResult
    problem: Any  # PoissonProblem, SaddleProblem, AijProblem or DistProblem
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
    (n,) eliminated rows, coords (ny, nx, 2). On -dist A is a DistAIJ and
    f this rank's rows of the zero-padded right-hand side."""

    A: Any
    f: torch.Tensor
    bc_mask: torch.Tensor
    coords: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistProblem:
    """The -dist route's system, each tensor this rank's patch: A the
    distributed stencil operator, f the right-hand side, bc_mask the
    eliminated nodes (boundary and padding); K and g on the saddle
    route."""

    A: pdist.DistStencilOperator
    f: torch.Tensor
    bc_mask: torch.Tensor
    grid: pdist.DistGrid
    K: Any = None  # DistSaddleOperator
    g: Any = None

    @property
    def coords(self):
        """The true grid's (ny, nx, 2) node coordinates, on the host."""
        return fem.uniform_node_coords(self.grid.nex, self.grid.ney, dtype=self.f.dtype)

    @property
    def Bf(self):
        return self.K.Bf

    @property
    def rhs(self):
        return (self.f, self.g)


def _view(obj, opts, flag, name, mesh, gather=gather_field):
    """viewers.view_from_options; on -dist the operator, or the vector's
    patches or rows (`gather`), are gathered first (every rank takes part)
    and rank 0 views the global object."""
    if mesh is not None and opts.has(flag):
        if isinstance(obj, pdist.DistStencilOperator):
            obj = obj.as_local()
        elif isinstance(obj, dist_csr.DistAIJ):
            obj = sparse.scipy_to_csr(obj.to_scipy(), device="cpu")
        else:
            obj = gather(obj, mesh)
        if mesh.rank != 0:
            return
    viewers.view_from_options(obj, opts, flag, name)


@contextlib.contextmanager
def _profiled(trace_dir, device, name="kspsolve"):
    """torch.profiler around the block (CPU activity, and CUDA activity on
    the card), written as a Chrome trace <name>.pt.trace.json into
    trace_dir; nothing when trace_dir is empty."""
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
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.pt.trace.json"))


def run(argv=None) -> CliRun:
    """Parse argv, assemble, solve, write outputs; return the whole run.

    With -dist: join or start the process group (`init_from_env`), run on
    this rank's patch, and destroy the group at the end if this run
    created it. Ranks other than 0 print nothing."""
    opts = Options(sys.argv[1:] if argv is None else argv)
    device = _device(opts)
    dtype_str = opts.get_str("dtype", "f64" if device.type == "cpu" else "f32")
    if dtype_str not in _DTYPES:
        raise ValueError(f"-dtype {dtype_str}: use f32 or f64")
    problem_type = opts.get_str("problem_type", "poisson")
    if problem_type not in ("poisson", "saddle"):
        raise ValueError(f"-problem_type {problem_type}: use poisson or saddle")
    if not opts.get_bool("dist"):
        return _run(opts, device, _DTYPES[dtype_str], problem_type, None)
    device, created = init_from_env(device)
    try:
        if problem_type == "poisson" and opts.get_str("mat_type", "stencil") in _AIJ_TYPES:
            # MATMPIAIJ: rows over a 1-D mesh of every rank; -mesh is not
            # read, as in the JAX CLI
            mesh = dist_csr.make_mesh_1d(device)
        else:
            mesh_str = opts.get_str("mesh", "")
            shape = tuple(int(t) for t in mesh_str.split(",")) if mesh_str else None
            mesh = ProcessMesh.create(shape, ny=opts.get_int("da_grid_y", 4), nx=opts.get_int("da_grid_x", 4),
                                      device=device)
        with contextlib.redirect_stdout(io.StringIO()) if mesh.rank else contextlib.nullcontext():
            return _run(opts, device, _DTYPES[dtype_str], problem_type, mesh)
    finally:
        if created:
            dist.destroy_process_group()


def _run(opts, device, dtype, problem_type, mesh) -> CliRun:
    log = monitor.LogView()
    mx = opts.get_int("da_grid_x", 4)
    my = opts.get_int("da_grid_y", 4)
    nex, ney = mx - 1, my - 1
    body_force = opts.get_str("body_force", "constant")
    mat_type = opts.get_str("mat_type", "stencil")
    aij_n = None  # rows of the flat -mat_type aij|dia|bdia solution
    with log.phase("Assembly"):
        if mat_type in _AIJ_TYPES and problem_type == "poisson":
            # MATAIJ route: the same system through the general sparse layer
            csr, f_flat, mask, coords = poisson.assemble_poisson_csr(
                nex, ney, dtype=dtype, device=device
            )
            aij_n = csr.shape[0]
            if mesh is not None:
                # MATMPIAIJ: every rank plans the whole CSR and keeps its
                # rows, the banded diag-block copy attached where it fits
                A = dist_csr.dist_aij_from_scipy(sparse.csr_to_scipy(csr), mesh, dtype=dtype)
                f_flat = dist_csr.pad_vector(f_flat, A.n_pad, mesh)
            elif mat_type == "dia":
                A, _ = sparse.csr_to_dia(csr)
            elif mat_type == "bdia":  # 2x2 blocks: the dof-interleaved layout
                A = sparse.bsr_to_bdia(sparse.csr_to_bsr(csr, block=2))
            else:
                A = csr
            b = f_flat
            prob = AijProblem(A, f_flat, mask, coords)
        elif mesh is not None:
            grid = pdist.DistGrid.create(nex, ney, mesh)
            if problem_type == "saddle":
                A, b, mask = pdist.assemble_saddle_dist(grid, dtype=dtype, body_force=body_force)
                prob = DistProblem(A.A, b[0], mask, grid, A, b[1])
            else:
                A, b, mask = pdist.assemble_poisson_dist(grid, dtype=dtype, body_force=body_force)
                prob = DistProblem(A, b, mask, grid)
        elif problem_type == "saddle":
            prob = saddle.assemble_saddle(nex, ney, dtype=dtype, device=device, body_force=body_force)
            A, b = prob.K, prob.rhs
        else:
            prob = poisson.assemble_poisson(nex, ney, dtype=dtype, device=device, body_force=body_force)
            A, b = prob.A, prob.f
        monitor.synchronize(prob.f)

    gather = gather_field if aij_n is None else gather_rows  # how a vector lies over the ranks
    _view(prob.A, opts, "A_mat_view", "A", mesh)
    _view(prob.f, opts, "f_vec_view", "f", mesh, gather)

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
    trace = "kspsolve" if mesh is None or mesh.rank == 0 else f"kspsolve.rank{mesh.rank}"
    with _profiled(opts.get_str("profile", ""), device, trace), log.phase("KSPSolve"):
        res = ksp.solve(b)
        monitor.synchronize(res.x)

    its = res.iterations
    print(
        f"{problem_type}: grid {mx}x{my} nodes, ksp={ksp.ksp_type} "
        f"pc={ksp.pc_type}, its={its}, reason={res.reason_name()}, "
        f"rnorm={float(res.rnorm):.6e}"
    )

    u = res.x[0] if problem_type == "saddle" else res.x
    _view(u, opts, "solution_view", "u", mesh, gather)
    if not opts.get_bool("no_vtk"):
        with log.phase("WriteVTK"):
            path = opts.get_str("vtk", "test.vtk")
            if aij_n is not None:  # flat MATAIJ solution -> field
                if mesh is not None:  # every rank's rows, to every rank
                    u = gather_rows(u, mesh)
                if mesh is None or mesh.rank == 0:
                    vtk.write_vtk(path, prob.coords, flat_to_field(u[:aij_n], my, mx))
            elif mesh is None:
                vtk.write_vtk(path, prob.coords, u)
            else:
                vtk.write_vtk_dist(path, prob.coords, u, mesh)

    if opts.get_bool("log_view"):
        log.report()
    if opts.get_bool("options_left") and (mesh is None or mesh.rank == 0):
        for name in opts.unused():
            print(f"WARNING! unused option: -{name}", file=sys.stderr)
    return CliRun(0 if res.converged_reason > 0 else 1, res, prob, ksp, log)


def main(argv=None):
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
