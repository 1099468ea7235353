"""The saddle-point block operator [[A, B^T], [B, 0]] (PyTorch twin of
`saddle_point_petsc_tpu.solvers.operators`).

An operator is any callable from a vector to a vector; a KKT vector is a
`(u, lam)` tuple of a (2, ny, nx) field and an (m,) multiplier vector.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def constraint_apply(Bf, u):
    """B u: (m, 2, ny, nx) rows against a (2, ny, nx) field -> (m,)."""
    return Bf.reshape(Bf.shape[0], -1) @ u.reshape(-1)


def constraint_apply_t(Bf, lam):
    """B^T lam: (m,) -> (2, ny, nx) field."""
    return (lam @ Bf.reshape(Bf.shape[0], -1)).reshape(Bf.shape[1:])


@dataclasses.dataclass(frozen=True)
class SaddleOperator:
    """KKT operator [[A, B^T], [B, 0]] acting on (u, lam) tuples.

    A: operator on (2, ny, nx) fields; Bf: the m constraint rows stored as
    dof-major fields (m, 2, ny, nx). At m = 4 the rows are a dense block:
    B u is one contraction and B^T lam a rank-m sum, both plain PyTorch.
    """

    A: Any
    Bf: torch.Tensor  # (m, 2, ny, nx)

    def __call__(self, v):
        u, lam = v
        return (self.A(u) + constraint_apply_t(self.Bf, lam), constraint_apply(self.Bf, u))

    @property
    def B(self):
        """Dense (m, n) natural-ordering view (tests/interop)."""
        m = self.Bf.shape[0]
        return self.Bf.permute(0, 2, 3, 1).reshape(m, -1)
