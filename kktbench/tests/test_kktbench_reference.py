"""The plain reference against known small cases, and against an
independent dense assembly and direct solve."""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch
from kkt_tiny import ROOT

from kktbench.reference import q1kkt


def test_element_matrix_known_values():
    ke = q1kkt.element_matrix(0.25)
    # per unit-less square: int dNa/dx^2 = 1/3, so the u_x diagonal is
    # 2 * 1/3 + 1/3 = 1 whatever the element's size
    assert np.allclose(np.diag(ke), 1.0, atol=1e-14)
    assert np.allclose(ke, ke.T, atol=1e-14)
    h = 0.25
    xy = [(ox * h, oy * h) for oy, ox in q1kkt._CORNERS]
    modes = [np.tile([1.0, 0.0], 4), np.tile([0.0, 1.0], 4), np.array([c for x, y in xy for c in (-y, x)])]
    for m in modes:  # translations and the rotation carry no energy
        assert np.abs(ke @ m).max() < 1e-14
    w = np.linalg.eigvalsh(ke)
    assert (w > -1e-14).all() and (w > 1e-10).sum() == 5


def _dense(n):
    """The KKT matrix assembled element by element, in dof order (c, j, i)."""
    ke = q1kkt.element_matrix(1.0 / (n - 1))
    N = 2 * n * n
    A = np.zeros((N, N))

    def dof(c, j, i):
        return c * n * n + j * n + i

    for j in range(n - 1):
        for i in range(n - 1):
            idx = [dof(c, j + oy, i + ox) for oy, ox in q1kkt._CORNERS for c in (0, 1)]
            A[np.ix_(idx, idx)] += ke
    boundary = [dof(c, j, i) for c in (0, 1) for j in range(n) for i in range(n)
                if j in (0, n - 1) or i in (0, n - 1)]
    A[boundary, :] = 0.0
    A[:, boundary] = 0.0
    A[boundary, boundary] = 1.0
    return A


def test_matvec_matches_dense_assembly():
    n = 6
    ref = q1kkt.Reference(n)
    u = torch.randn((2, n, n), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    y = ref.apply_A(u).numpy().ravel()
    assert np.abs(y - _dense(n) @ u.numpy().ravel()).max() < 1e-12


def test_constraint_rows_known_values():
    n = 5
    B = q1kkt.constraint_rows(n).numpy()
    h = 1.0 / (n - 1)
    # int N_a over the domain is h^2 for an interior node; int x N_a is
    # x_a h^2 on a uniform grid (the hat is symmetric about its node)
    xs = np.linspace(0, 1, n)
    inner = np.zeros((n, n), bool)
    inner[1:-1, 1:-1] = True
    assert np.allclose(B[0, 0][inner], h * h) and np.allclose(B[1, 1][inner], h * h)
    assert np.allclose(B[2, 0], np.where(inner, xs[None, :] * h * h, 0.0))
    assert np.allclose(B[3, 1], np.where(inner, xs[:, None] * h * h, 0.0))
    assert not B[0, 1].any() and not B[1, 0].any() and not B[:, :, ~inner].any()


def test_residual_of_a_direct_solve():
    """resid ~ 1e-14 for the dense KKT system's direct solution; 1 for
    x = 0; the constraint read as a cosine."""
    n = 9
    ref = q1kkt.Reference(n)
    A = _dense(n)
    B = ref.B.numpy().reshape(4, -1)
    K = sps.bmat([[sps.csr_matrix(A), sps.csr_matrix(B.T)], [sps.csr_matrix(B), None]]).tocsc()
    f = torch.zeros((2, n, n), dtype=torch.float64)
    f[:, 1:-1, 1:-1] = torch.randn((2, n - 2, n - 2), dtype=torch.float64,
                                   generator=torch.Generator().manual_seed(2))
    g = torch.zeros(4, dtype=torch.float64)
    x = spla.spsolve(K, np.concatenate([f.numpy().ravel(), g.numpy()]))
    u, lam = torch.from_numpy(x[:-4].reshape(2, n, n)), torch.from_numpy(x[-4:])
    r = ref.residuals(u, lam, f, g, modes=3)
    assert r["resid"] < 1e-12 and r["resid_smooth"] < 1e-12 and r["constraint"] < 1e-12
    zero = ref.residuals(torch.zeros_like(u), torch.zeros(4, dtype=torch.float64), f, g, modes=3)
    assert zero["resid"] == 1.0 and abs(zero["resid_smooth"] - 1.0) < 1e-14
    assert ref.residuals(u, 0 * lam, f, g, modes=3)["resid"] > 1e-6


def test_smooth_norm_is_the_projection():
    """The sine modes are orthonormal on the interior nodes: a sum of the
    lowest modes keeps its norm, a higher mode projects to nothing."""
    n = 12
    ref = q1kkt.Reference(n)
    t = torch.arange(n, dtype=torch.float64) * torch.pi / (n - 1)
    low = torch.stack([torch.outer(torch.sin(2 * t), torch.sin(t)), 3 * torch.outer(torch.sin(t), torch.sin(3 * t))])
    high = torch.outer(torch.sin(5 * t), torch.sin(t))[None].repeat(2, 1, 1)
    assert abs(ref.smooth_norm(low, 3) / torch.linalg.vector_norm(low) - 1) < 1e-13
    assert ref.smooth_norm(high, 3) < 1e-13


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import kktbench.reference.q1kkt; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'saddle_point_petsc_tpu', 'saddle_point_petsc_tpu_torch'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
