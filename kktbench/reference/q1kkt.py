"""Plain float64 reference of the constrained Q1 KKT system that the
benchmark's configurations solve, written from the grid and the element
definition alone.

The system, on the unit square with n x n nodes (h = 1 / (n - 1)):

    [[A, B^T], [B, 0]] (u, lam) = (f, g)

- A: the Q1 vector-Laplace ("stress") operator, element stiffness
  Ke = int B_e^T diag(2, 2, 1) B_e over each element, B_e the 3 x 8
  strain-displacement matrix with rows (dN/dx, 0), (0, dN/dy),
  (dN/dy, dN/dx); Dirichlet nodes (the boundary) eliminated
  symmetrically: their rows and columns are zero and their diagonal 1.
- B: four constraint functionals restricted to interior dofs,
  int u_x, int u_y, int x u_x, int y u_y, each integrated over the
  elements and scattered to the nodes.

Every element of a uniform grid is the same, so A is a constant 9-point
stencil of 2 x 2 blocks, `stencil(n)`, applied here by shifted sums.
Integrals use the 2 x 2 Gauss rule with the exact point 1/sqrt(3), which
is exact for these bilinear and quadratic integrands.

Imports torch and numpy only: nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_G = 1.0 / math.sqrt(3.0)
# Gauss points (xi, eta) on [-1, 1]^2, weight 1 each
_GAUSS = ((-_G, -_G), (-_G, _G), (_G, -_G), (_G, _G))
# element nodes as (row offset, column offset) from the lower-left node
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _shape(xi, eta):
    """Bilinear shape values and reference gradients at (xi, eta), node
    order `_CORNERS` (row = eta direction, column = xi direction)."""
    vals, dxi, deta = [], [], []
    for oy, ox in _CORNERS:
        sx, sy = (2 * ox - 1), (2 * oy - 1)
        vals.append(0.25 * (1 + sx * xi) * (1 + sy * eta))
        dxi.append(0.25 * sx * (1 + sy * eta))
        deta.append(0.25 * sy * (1 + sx * xi))
    return np.array(vals), np.array(dxi), np.array(deta)


def element_matrix(h):
    """The 8 x 8 element stiffness of a square h x h element, dofs ordered
    (node, component) with nodes in `_CORNERS` order."""
    ke = np.zeros((8, 8))
    det = (h / 2) ** 2
    D = np.diag([2.0, 2.0, 1.0])
    for xi, eta in _GAUSS:
        _, dxi, deta = _shape(xi, eta)
        dx, dy = dxi * 2 / h, deta * 2 / h
        B = np.zeros((3, 8))
        B[0, 0::2] = dx
        B[1, 1::2] = dy
        B[2, 0::2] = dy
        B[2, 1::2] = dx
        ke += det * B.T @ D @ B
    return ke


def stencil(n):
    """W[c, d, sy + 1, sx + 1]: the coefficient of x[d] at node (j + sy,
    i + sx) in row (c, j, i) of A, for an interior node of the n x n grid,
    before elimination."""
    ke = element_matrix(1.0 / (n - 1))
    W = np.zeros((2, 2, 3, 3))
    for a, (ay, ax) in enumerate(_CORNERS):
        for b, (by, bx) in enumerate(_CORNERS):
            W[:, :, by - ay + 1, bx - ax + 1] += ke[2 * a : 2 * a + 2, 2 * b : 2 * b + 2]
    return W


def interior_mask(n, device=None):
    """(n, n) bool: True on the nodes that are not on the boundary."""
    m = torch.zeros((n, n), dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def constraint_rows(n, device=None):
    """B as (4, 2, n, n) float64 node fields, zero on the boundary."""
    h = 1.0 / (n - 1)
    xs = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=device)
    rows = torch.zeros((4, 2, n, n), dtype=torch.float64, device=device)
    det = (h / 2) ** 2
    for xi, eta in _GAUSS:
        vals, _, _ = _shape(xi, eta)
        # physical Gauss point of every element (element (j, i): lower-left
        # node (j, i)), as (n-1,) vectors along each axis
        gx = xs[:-1] + (1 + xi) * h / 2
        gy = xs[:-1] + (1 + eta) * h / 2
        one = torch.ones((n - 1, n - 1), dtype=torch.float64, device=device)
        weights = (one, one, one * gx[None, :], one * gy[:, None])
        for a, (oy, ox) in enumerate(_CORNERS):
            for r, w in enumerate(weights):
                # in place: rows is the accumulator made above
                rows[r, r % 2, oy : oy + n - 1, ox : ox + n - 1] += det * vals[a] * w
    return torch.where(interior_mask(n, device), rows, 0.0)


class Reference:
    """The reference KKT operator of an n x n grid in float64 on `device`."""

    def __init__(self, n, device=None):
        self.n = n
        self.device = device
        self.W = torch.tensor(stencil(n), dtype=torch.float64, device=device)
        self.B = constraint_rows(n, device)
        self.inner = interior_mask(n, device)

    def apply_A(self, u):
        """A u for a (2, n, n) float64 field."""
        n = self.n
        xp = torch.nn.functional.pad(torch.where(self.inner, u, 0.0), (1, 1, 1, 1))
        y = torch.zeros_like(u)
        for sy in range(3):
            for sx in range(3):
                shifted = xp[:, sy : sy + n, sx : sx + n]
                # in place: y is the accumulator made above
                y += torch.einsum("cd,dji->cji", self.W[:, :, sy, sx], shifted)
        return torch.where(self.inner, y, u)

    def smooth_norm(self, r, modes):
        """|P r| for a (2, n, n) field: P projects each component onto the
        lowest modes x modes discrete sine modes of the interior nodes,
        orthonormal there."""
        n = self.n
        t = torch.arange(n, dtype=torch.float64, device=self.device)
        k = torch.arange(1, modes + 1, dtype=torch.float64, device=self.device)
        S = math.sqrt(2.0 / (n - 1)) * torch.sin(k[:, None] * t[None, :] * (math.pi / (n - 1)))
        return torch.linalg.vector_norm(torch.einsum("lj,cji,ki->clk", S, r, S))

    def residuals(self, u, lam, f, g, modes):
        """The compared numbers of a candidate solution, in float64:

        resid = |f - A u - B^T lam| / |f|, the relative residual of the
        velocity rows;
        resid_smooth = |P (f - A u - B^T lam)| / |P f|, the same in the
        lowest modes x modes sine modes, where the loads lie (the rounding
        of an answer to float32 puts little there);
        constraint = max_r |g_r - B_r . u| / (|B_r| |u|), how far u is from
        meeting each constraint, as a cosine."""
        u = u.to(device=self.device, dtype=torch.float64)
        lam = lam.to(device=self.device, dtype=torch.float64)
        f = f.to(device=self.device, dtype=torch.float64)
        g = g.to(device=self.device, dtype=torch.float64)
        ru = f - self.apply_A(u) - torch.einsum("r,rcji->cji", lam, self.B)
        resid = (torch.linalg.vector_norm(ru) / torch.linalg.vector_norm(f)).item()
        resid_smooth = (self.smooth_norm(ru, modes) / self.smooth_norm(f, modes)).item()
        bu = torch.einsum("rcji,cji->r", self.B, u)
        scale = torch.linalg.vector_norm(self.B.reshape(4, -1), dim=1) * torch.linalg.vector_norm(u)
        constraint = (torch.abs(g - bu) / torch.clamp_min(scale, torch.finfo(torch.float64).tiny)).max().item()
        return {"resid": resid, "resid_smooth": resid_smooth, "constraint": constraint}
