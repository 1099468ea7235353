"""saddle_point_petsc_tpu_torch — the PyTorch/CUDA port of saddle_point_petsc_tpu.

Each module here is the twin of the module of the same name in the JAX
package (`saddle_point_petsc_tpu`), which stays the numerical reference.
This package imports `torch` and never `jax`.

Ported so far: the serial saddle-point (KKT) solve on the stencil
operator and the general-sparse route. Q1 FEM assembly (models/), the
stencil, CSR/BSR/ELL/DIA/block-DIA operators (ops/) with hand-written CUDA
kernels for every TPU kernel of the JAX package (ops/cuda/, csrc/), the
KKT operator, every serial preconditioner but ILU(0) (solvers/precond.py:
Jacobi, point-block and block Jacobi, red-black SOR, Chebyshev, fieldsplit,
Schur, inner KSP), geometric multigrid (solvers/multigrid.py), smoothed
aggregation AMG (solvers/amg.py), every Krylov solver (solvers/krylov.py),
mixed-precision refinement (solvers/refine.py), the KSP object, monitors,
viewers, VTK output and the CLI.

A tensor on the CPU goes through each kernel's plain PyTorch version; a
tensor on a CUDA device goes through the kernel.
"""

__version__ = "0.1.0"

from saddle_point_petsc_tpu_torch.utils.options import Options  # noqa: F401
