"""Plain float64 reference of the 2-D 5-point Laplacian that the
`poisson5` problem solves (PETSc's KSP tutorial ex2.c), written from the
grid alone.

On an n x n node grid with the boundary nodes eliminated (Dirichlet), the
unknowns are the (n - 2)^2 interior nodes and

    (A u)[j, i] = 4 u[j, i] - u[j - 1, i] - u[j + 1, i] - u[j, i - 1] - u[j, i + 1],

with u = 0 on the boundary. Its eigenvectors are the discrete sine modes
s_kl[j, i] = sin(k pi i / (n - 1)) sin(l pi j / (n - 1)), k, l = 1 .. n - 2,
with eigenvalues lambda_kl = 4 - 2 cos(k pi / (n - 1)) - 2 cos(l pi / (n - 1)).
A load f = sum_kl a_kl s_kl therefore has the exact discrete solution
u* = sum_kl a_kl s_kl / lambda_kl: no solve, and nothing of the code under
test.

Imports torch only.
"""
from __future__ import annotations

import math

import torch


def sines(modes, n, device=None):
    """(modes, n) float64 sin(k pi t / (n - 1)), k = 1 .. modes, at the
    nodes t = 0 .. n - 1 (zero on the boundary nodes)."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    k = torch.arange(1, modes + 1, dtype=torch.float64, device=device)
    s = torch.sin(k[:, None] * t[None, :] * (math.pi / (n - 1)))
    s[:, 0] = 0.0  # in place: s is the fresh table made above
    s[:, n - 1] = 0.0
    return s


def eigenvalues(modes, n, device=None):
    """(modes, modes) float64 lambda[l, k] of the sine mode s_kl."""
    k = torch.arange(1, modes + 1, dtype=torch.float64, device=device)
    c = 2.0 - 2.0 * torch.cos(k * (math.pi / (n - 1)))
    return c[:, None] + c[None, :]


class Reference:
    """The reference operator of an n x n node grid in float64 on `device`."""

    def __init__(self, n, device=None):
        self.n = n
        self.device = device

    def apply(self, u):
        """A u for an (n, n) float64 node field, zero on the boundary in and
        out."""
        y = torch.zeros_like(u)
        c = u[1:-1, 1:-1]
        y[1:-1, 1:-1] = 4.0 * c - u[:-2, 1:-1] - u[2:, 1:-1] - u[1:-1, :-2] - u[1:-1, 2:]
        return y

    def field(self, a):
        """sum_kl a[l, k] s_kl as an (n, n) node field, a (modes, modes)."""
        s = sines(a.shape[0], self.n, self.device)
        return torch.einsum("lj,lk,ki->ji", s, a, s)

    def exact(self, a):
        """u* of the load with amplitudes a[l, k]: sum_kl a[l, k] s_kl / lambda_kl."""
        return self.field(a / eigenvalues(a.shape[0], self.n, self.device))

    def smooth_norm(self, r, modes):
        """|P r| for an (n, n) field: P projects onto the lowest modes x modes
        sine modes of the interior nodes, orthonormal there."""
        S = math.sqrt(2.0 / (self.n - 1)) * sines(modes, self.n, self.device)
        return torch.linalg.vector_norm(torch.einsum("lj,ji,ki->lk", S, r, S))

    def numbers(self, u, a):
        """The compared numbers of a candidate solution u (an (n, n) node
        field) to the load with amplitudes a (modes, modes), in float64:

        err = |u - u*| / |u*|, the relative error against the exact
        discrete solution;
        resid_smooth = |P (f - A u)| / |P f|, the relative residual in the
        lowest modes x modes sine modes, where the loads lie."""
        u = u.to(device=self.device, dtype=torch.float64)
        a = a.to(device=self.device, dtype=torch.float64)
        star = self.exact(a)
        f = self.field(a)
        err = (torch.linalg.vector_norm(u - star) / torch.linalg.vector_norm(star)).item()
        modes = a.shape[0]
        resid_smooth = (self.smooth_norm(f - self.apply(u), modes) / self.smooth_norm(f, modes)).item()
        return {"err": err, "resid_smooth": resid_smooth}
