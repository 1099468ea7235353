"""saddle_point_petsc_tpu_torch — the PyTorch/CUDA port of saddle_point_petsc_tpu.

Each module here is the twin of the module of the same name in the JAX
package (`saddle_point_petsc_tpu`), which stays the numerical reference.
This package imports `torch` and never `jax`.

Ported so far: the serial saddle-point (KKT) main path on the stencil
operator — Q1 FEM assembly (models/fem.py, models/poisson.py,
models/saddle.py), the stencil operator (ops/stencil.py) with its
hand-written CUDA SpMV kernel (ops/cuda/spmv.py, csrc/stencil_spmv.cu),
the KKT operator, Jacobi and Schur preconditioners, CG/MINRES/GMRES/FGMRES,
the KSP driver, monitors, viewers, VTK output and the CLI.

A tensor on the CPU goes through each kernel's plain PyTorch version; a
tensor on a CUDA device goes through the kernel.
"""

__version__ = "0.1.0"

from saddle_point_petsc_tpu_torch.utils.options import Options  # noqa: F401
