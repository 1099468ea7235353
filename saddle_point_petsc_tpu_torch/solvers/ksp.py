"""KSP: options-configured Krylov solve driver (PyTorch twin of
`saddle_point_petsc_tpu.solvers.ksp`), serial, on the distributed stencil
operators (parallel/dist.py) and on the row-partitioned DistAIJ
(parallel/dist_csr.py).

Supported options (prefix-scoped):
  -ksp_type {cg,minres,gmres,fgmres,bcgs,richardson,chebyshev}  [gmres]
  -ksp_rtol <r> [1e-5]   -ksp_atol <a> [1e-50]   -ksp_divtol <d> [1e5]
  -ksp_max_it <n> [10000]   -ksp_gmres_restart <m> [30]
  -ksp_norm_type {preconditioned,unpreconditioned,natural} (CG)
  -ksp_chebyshev_eigenvalues <lmin>,<lmax>  (default: estimated, the
                                  window (0.1, 1.1) * lambda_max(M A))
  -ksp_monitor   -ksp_converged_reason   -ksp_view
  -pc_type {none,jacobi,pbjacobi,sor,bjacobi,ilu,chebyshev,fieldsplit,mg,
           gamg} on a stencil operator (pbjacobi also on a BSR; bjacobi and
           ilu also on a CSR; none, jacobi, gamg on CSR and DIA; none,
           jacobi on block-DIA), {none,fieldsplit} on a SaddleOperator
           [jacobi]
  -pc_ilu_sweeps <k> [6]  (0: on a CSR the exact triangular solves,
           level-scheduled; on a stencil D^-1 alone, as in the JAX package)
  -pc_sor_omega <w> [1.0]   -pc_sor_its <k> [1]
  -pc_bjacobi_blocks <n> [4]
  -pc_chebyshev_lmin <a> [0.1]   -pc_chebyshev_lmax <b> [1.1]
  -pc_chebyshev_its <k> [3]      -pc_chebyshev_esteig
  -pc_mg_levels <n> [10]   -pc_mg_smoother {sor,sor-fb,chebyshev,jacobi} [sor]
  -pc_mg_cycles <k> [1]  (mg: V-cycles per apply; gamg: 1 = V, 2 = W)
  -pc_gamg_threshold <t> [0.08]   -pc_gamg_coarse_eq_limit <n> [500]
  -pc_gamg_smooth_its <k> [2]
  -pc_gamg_setup {global,stream} [global]  (on a DistAIJ; stream: each rank
           builds the levels from its own rows, O(local nnz))
  -pc_fieldsplit_type {additive,multiplicative} on a stencil [additive];
                      schur on the KKT system
  -pc_fieldsplit_schur_fact_type {diag,lower,upper,full}
  -fieldsplit_inner_pc_type <any PC type above>  (the Schur A-block)
  -fieldsplit_inner_ksp_type <ksp type>  (an inner KSP as the A-block
      solve, KSPInnerPC; -fieldsplit_inner_ksp_rtol [1e-2],
      -fieldsplit_inner_ksp_max_it [10])

On a DistStencilOperator: none, jacobi, pbjacobi, chebyshev
(-pc_chebyshev_esteig), bjacobi (one block per rank: -sub_pc_type ilu
[default] -> per-patch ILU(0) with -pc_ilu_sweeps, any other -> Chebyshev
local solves with -pc_bjacobi_local_its [8]), ilu (= bjacobi + ILU(0)),
sor (the global red-black SOR, one halo exchange a half-step), fieldsplit
(additive or multiplicative, `dist_fieldsplit`) and mg (the distributed
hierarchy, `mg_pc_dist`, with the -pc_mg_* options); the Schur fieldsplit
on a DistSaddleOperator, whose A-block takes any of these. gamg raises
the JAX package's TypeError (its setup reads no distributed stencil).

On a DistAIJ (MATMPIAIJ, parallel/dist_csr.py): none, jacobi, chebyshev
(no -pc_chebyshev_esteig: the JAX package's estimate needs a grid),
bjacobi (one block per rank: -sub_pc_type ilu [default] -> per-rank ILU(0)
with -pc_ilu_sweeps, any other -> Chebyshev local solves with
-pc_bjacobi_local_its [8]), ilu (= bjacobi + ILU(0)) and gamg (the
distributed hierarchy, `amg.dist_amg_pc`, with -pc_gamg_setup); sor and
fieldsplit raise the JAX package's ValueError.

`KSP.set_up` runs under the span `PCSetUp`, `KSP.solve` under `KSPSolve`
and `KSP.mat_solve` under `KSPMatSolve` (utils/monitor.py).

`KSP.mat_solve` (KSPMatSolve) solves for a batch of k right-hand sides
with the pseudo-block CG (-ksp_type cg only, as in the JAX package) on a
stencil, CSR, DIA or DistAIJ operator; none and jacobi scale the whole
batch, any other PC applies column by column.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Optional

import torch

from saddle_point_petsc_tpu_torch.ops import sparse as sp
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
from saddle_point_petsc_tpu_torch.parallel.dist import DistStencilOperator, dist_block_jacobi, dist_fieldsplit
from saddle_point_petsc_tpu_torch.parallel.dist_csr import DistAIJ, dist_aij_block_jacobi, dist_aij_ilu0
from saddle_point_petsc_tpu_torch.solvers import krylov, precond
from saddle_point_petsc_tpu_torch.solvers.amg import amg_pc, dist_amg_pc
from saddle_point_petsc_tpu_torch.solvers.ilu_stencil import dist_ilu0, stencil_ilu0
from saddle_point_petsc_tpu_torch.solvers.multigrid import mg_pc, mg_pc_dist
from saddle_point_petsc_tpu_torch.solvers.operators import SaddleOperator
from saddle_point_petsc_tpu_torch.utils.monitor import span
from saddle_point_petsc_tpu_torch.utils.options import Options


def make_pc(pc_type: str, A, opts: Optional[Options] = None, ksp_type=None):
    """Build a preconditioner for operator A from options (PC factory).

    On the KKT system the Schur factorization defaults to "diag" for
    MINRES/CG (they need an SPD PC) and "full" for (F)GMRES.
    """
    opts = opts if opts is not None else Options()
    if pc_type in ("none", ""):
        return precond.IdentityPC()

    if isinstance(A, SaddleOperator):
        if pc_type != "fieldsplit":
            raise ValueError(
                f"pc_type {pc_type!r} unsupported for the KKT block system;"
                " use -pc_type fieldsplit (schur)"
            )
        fs_type = opts.get_str("pc_fieldsplit_type", "schur")
        if fs_type != "schur":
            raise ValueError(
                f"-pc_fieldsplit_type {fs_type!r} unsupported for the KKT"
                " block system (zero (1,1) block); use schur"
            )
        default_fact = "diag" if ksp_type in ("minres", "cg") else "full"
        fact = opts.get_str("pc_fieldsplit_schur_fact_type", default_fact)
        inner_type = opts.get_str("fieldsplit_inner_ksp_type", "none")
        inner = make_pc(opts.get_str("fieldsplit_inner_pc_type", "jacobi"), A.A, opts)
        if inner_type != "none":
            inner = precond.KSPInnerPC(
                A.A,
                inner,
                solver=inner_type,
                rtol=opts.get_float("fieldsplit_inner_ksp_rtol", 1e-2),
                maxiter=opts.get_int("fieldsplit_inner_ksp_max_it", 10),
            )
        return precond.schur_pc(A.A, A.Bf, inner, fact_type=fact)

    if pc_type == "jacobi":
        return precond.jacobi(A)
    if pc_type == "pbjacobi":
        return precond.pbjacobi(A)
    if pc_type == "sor":
        # on a DistStencilOperator: the global red-black SOR, each rank
        # colouring its patch by the parity of its global origin
        if not isinstance(A, (StencilOperator, DistStencilOperator)):
            raise ValueError("sor PC requires a stencil operator")
        return precond.sor(
            A, omega=opts.get_float("pc_sor_omega", 1.0), sweeps=opts.get_int("pc_sor_its", 1)
        )
    if pc_type == "bjacobi":
        # PETSc's parallel bjacobi takes its per-block solver from
        # -sub_pc_type (ilu by default, as PETSc)
        sub = opts.get_str("sub_pc_type", "ilu")
        if isinstance(A, DistAIJ):  # one block per rank
            if sub == "ilu":
                return dist_aij_ilu0(A, sweeps=opts.get_int("pc_ilu_sweeps", 6))
            return dist_aij_block_jacobi(A, iters=opts.get_int("pc_bjacobi_local_its", 8))
        if isinstance(A, DistStencilOperator):  # one block per rank
            if sub == "ilu":
                return dist_ilu0(A, sweeps=opts.get_int("pc_ilu_sweeps", 6))
            return dist_block_jacobi(A, iters=opts.get_int("pc_bjacobi_local_its", 8))
        nb = opts.get_int("pc_bjacobi_blocks", 4)
        if isinstance(A, StencilOperator):
            return precond.block_jacobi_stencil(A, nb)
        if isinstance(A, sp.CSR):
            return precond.block_jacobi(A, nb)
        raise ValueError("bjacobi PC requires stencil or CSR operator")
    if pc_type == "ilu":
        sweeps = opts.get_int("pc_ilu_sweeps", 6)
        if isinstance(A, DistAIJ):
            # PETSc's parallel ilu: bjacobi with a per-rank ILU(0)
            return dist_aij_ilu0(A, sweeps=sweeps)
        if isinstance(A, DistStencilOperator):
            # PETSc's parallel ilu: bjacobi with a per-patch ILU(0)
            return dist_ilu0(A, sweeps=sweeps)
        if isinstance(A, StencilOperator):
            # factors in stencil form: every sweep a stencil matvec (B1)
            return stencil_ilu0(A, sweeps=sweeps)
        if isinstance(A, sp.CSR):
            return precond.ilu0(A, sweeps=sweeps)
        raise ValueError("ilu PC requires stencil or CSR operator")
    if pc_type == "chebyshev":
        lmin = opts.get_float("pc_chebyshev_lmin", 0.1)
        lmax = opts.get_float("pc_chebyshev_lmax", 1.1)
        if opts.get_bool("pc_chebyshev_esteig") and isinstance(A, (StencilOperator, DistStencilOperator)):
            # PETSc -pc_chebyshev_esteig: a power-iteration bound on
            # lambda_max(D^-1 A), with the window (0.1, 1.1) * lmax
            tmpl = torch.zeros_like(A.diagonal())  # a field, or this rank's patch of one
            est = precond.estimate_lmax(A, M=precond.jacobi(A), template=tmpl)
            lmin, lmax = 0.1 * 1.1 * est, 1.1 * est
        return precond.chebyshev_pc(A, lmin=lmin, lmax=lmax, iters=opts.get_int("pc_chebyshev_its", 3))
    if pc_type == "fieldsplit":
        fs_type = opts.get_str("pc_fieldsplit_type", "additive")
        if isinstance(A, DistStencilOperator):
            return dist_fieldsplit(A, fs_type=fs_type)
        if not isinstance(A, StencilOperator):
            raise ValueError("fieldsplit PC requires a stencil operator")
        return precond.fieldsplit(A, fs_type=fs_type)
    if pc_type == "mg":
        if isinstance(A, DistStencilOperator):
            return mg_pc_dist(A, opts)
        if not isinstance(A, StencilOperator):
            raise ValueError("mg PC requires a stencil operator")
        return mg_pc(A, opts)
    if pc_type == "gamg":
        # PCGAMG (smoothed aggregation) from the assembled matrix alone
        if isinstance(A, DistAIJ):
            return dist_amg_pc(A, opts)
        return amg_pc(A, opts)
    raise ValueError(f"unknown pc_type {pc_type!r}")


@dataclasses.dataclass
class KSP:
    """Krylov solve context configured from the options database."""

    opts: Options = dataclasses.field(default_factory=Options)
    prefix: str = ""
    ksp_type: str = "gmres"
    pc_type: str = "jacobi"
    rtol: float = 1e-5
    atol: float = 1e-50
    dtol: float = 1e5
    max_it: int = 10000
    restart: int = 30
    monitor: bool = False
    norm_type: str = "preconditioned"
    A: Any = None
    M: Any = None

    def _opts(self):
        return self.opts.scoped(self.prefix) if self.prefix else self.opts

    def set_operators(self, A, M=None):
        self.A = A
        self.M = M
        return self

    def set_from_options(self):
        """Read -ksp_*/-pc_* (with this KSP's prefix) from the database."""
        o = self._opts()
        self.ksp_type = o.get_str("ksp_type", self.ksp_type)
        self.rtol = o.get_float("ksp_rtol", self.rtol)
        self.atol = o.get_float("ksp_atol", self.atol)
        self.dtol = o.get_float("ksp_divtol", self.dtol)
        self.max_it = o.get_int("ksp_max_it", self.max_it)
        self.restart = o.get_int("ksp_gmres_restart", self.restart)
        self.monitor = o.get_bool("ksp_monitor", self.monitor)
        self.norm_type = o.get_str("ksp_norm_type", self.norm_type)
        self.pc_type = o.get_str("pc_type", self.pc_type)
        return self

    def set_up(self):
        """Build the PC (KSPSetUp)."""
        if self.M is None and self.A is not None:
            with span("PCSetUp"):
                self.M = make_pc(self.pc_type, self.A, self._opts(), ksp_type=self.ksp_type)
        return self

    def view(self):
        """PETSc -ksp_view-style description of the configured solve."""
        lines = [
            "KSP Object:",
            f"  type: {self.ksp_type}",
            (
                f"  maximum iterations={self.max_it}, "
                f"tolerances: relative={self.rtol:g}, "
                f"absolute={self.atol:g}, divergence={self.dtol:g}"
            ),
            f"  norm type: {self.norm_type}",
        ]
        if self.ksp_type in ("gmres", "fgmres"):
            lines.append(f"  restart={self.restart}")
        lines += [
            "PC Object:",
            f"  type: {self.pc_type}",
            f"  implementation: {type(self.M).__name__}"
            if self.M is not None
            else "  (not set up)",
        ]
        if self.A is not None:
            shape = getattr(self.A, "shape", None)
            lines.append(
                f"Mat Object: {type(self.A).__name__}"
                + (f", size {shape[0]}x{shape[1]}" if shape else "")
            )
        return "\n".join(lines)

    def mat_solve(self, B, x0=None) -> krylov.KrylovResult:
        """Solve A X = B for a batch of right-hand sides on a leading k axis
        (PETSc KSPMatSolve): the pseudo-block CG, `krylov.cg_multi`.

        B is (k, 2, ny, nx) for a stencil operator, whose batched product
        is `matmat_field` (kernel B2 on a CUDA device), and (k, n) for
        the others, whose batched product is `A.matmat` on the transposed
        view of the batch, without a copy (kernel B6 for a CUDA DIA); for
        a DistAIJ, B is this rank's (k, n_loc) rows and the product its
        bound `matmat_batch`, through which cg_multi finds the mesh. The
        elementwise PCs (none, jacobi) scale the whole batch at once, with
        each column's bits; the others apply column by column."""
        if self.ksp_type != "cg":
            raise ValueError(
                "mat_solve implements the pseudo-block CG (KSPMatSolve) only; "
                f"got ksp_type={self.ksp_type}"
            )
        with span("KSPMatSolve"):
            if self.M is None:
                self.set_up()
            A, M = self.A, self.M
            if isinstance(A, (StencilOperator, DistStencilOperator)):
                Ab = A.matmat_field
            elif isinstance(A, DistAIJ):
                Ab = A.matmat_batch
            else:
                def Ab(X):
                    return A.matmat(X.T).T
            if isinstance(M, (precond.IdentityPC, precond.JacobiPC)):
                Mb = M
            else:
                def Mb(R):
                    return torch.stack([M(r) for r in R])
            return krylov.cg_multi(
                Ab, B, M=Mb, x0=x0, rtol=self.rtol, atol=self.atol, dtol=self.dtol,
                maxiter=self.max_it,
            )

    def solve(self, b, x0=None) -> krylov.KrylovResult:
        if self.ksp_type not in krylov.SOLVERS:
            raise ValueError(f"unknown ksp_type {self.ksp_type!r}")
        with span("KSPSolve"):
            if self.M is None:
                self.set_up()
            o = self._opts()
            if o.get_bool("ksp_view"):
                print(self.view())
            kwargs = dict(
                M=self.M,
                x0=x0,
                rtol=self.rtol,
                atol=self.atol,
                dtol=self.dtol,
                maxiter=self.max_it,
                monitor=self.monitor,
            )
            if self.ksp_type in ("gmres", "fgmres"):
                kwargs["restart"] = self.restart
            if self.ksp_type == "cg":
                kwargs["norm_type"] = self.norm_type
            if self.ksp_type == "chebyshev":
                # PETSc KSPCHEBYSHEV: the bounds (0.1, 1.1) * lambda_max(M A)
                # from a power iteration, unless -ksp_chebyshev_eigenvalues
                # lmin,lmax gives them
                ev = o.get_str("ksp_chebyshev_eigenvalues", "")
                if ev:
                    lmin, lmax = (float(t) for t in ev.split(","))
                else:
                    est = precond.estimate_lmax(self.A, M=self.M, template=b)
                    lmin, lmax = 0.1 * est, 1.1 * est
                kwargs["lmin"], kwargs["lmax"] = lmin, lmax
            res = krylov.SOLVERS[self.ksp_type](self.A, b, **kwargs)
            if o.get_bool("ksp_converged_reason"):
                word = "CONVERGED" if res.converged_reason > 0 else "DIVERGED"
                print(
                    f"Linear solve {word} due to {res.reason_name()} "
                    f"iterations {res.iterations}",
                    file=sys.stdout,
                )
            return res
