"""Q1 finite-element numerics, batched over the whole grid (PyTorch twin of
`saddle_point_petsc_tpu.models.fem`).

- Gauss quadrature (2x2 rule), Q1 shape functions N_i and their
  reference-space gradients dN/dxi
- isoparametric map dN/dx, detJ
- element stiffness of the vector-Laplace ("stress") operator
- element load vector
- uniform node coordinates and per-element corner coordinates
- global equation numbers per element (the CSR assembly)

Node numbering within an element is CCW from the lower-left corner:

    n1=(i,j+1) --- n2=(i+1,j+1)
       |               |
    n0=(i,j)   --- n3=(i+1,j)

Equation ordering is (node, dof)-interleaved: eqn[2*a + c] = dof c of node a.

Every contraction here is a small batched matrix product. A float32
product on a CUDA device runs in full float32 unless
`torch.backends.cuda.matmul.allow_tf32` is set; the CLI clears it, since
these products cancel O(1) coordinates down to O(h) entries.

Spans (utils/monitor.py): `element_stiffness` runs under
`FEElementMatrices`, `element_rhs` under `FEElementRHS`.
"""
from __future__ import annotations

import math

import torch

from saddle_point_petsc_tpu_torch.utils.monitor import span

DIM = 2
NODES_PER_ELEMENT = 4
U_DOF = 2
GAUSS_POINTS = 4

# 1/sqrt(3) to 11 digits, the same literal as the JAX package, so both
# packages integrate with identical points.
_GP = 0.57735026919


def gauss_quadrature_q1(dtype=torch.float64, device=None):
    """2x2 Gauss rule on [-1,1]^2. Returns (xi (4,2), w (4,))."""
    xi = torch.tensor(
        [[-_GP, -_GP], [-_GP, _GP], [_GP, _GP], [_GP, -_GP]],
        dtype=dtype,
        device=device,
    )
    w = torch.ones((4,), dtype=dtype, device=device)
    return xi, w


def shape_q1(xi):
    """Q1 bilinear shape functions, shape (..., 4)."""
    x, e = xi[..., 0], xi[..., 1]
    return torch.stack(
        [
            0.25 * (1.0 - x) * (1.0 - e),
            0.25 * (1.0 - x) * (1.0 + e),
            0.25 * (1.0 + x) * (1.0 + e),
            0.25 * (1.0 + x) * (1.0 - e),
        ],
        dim=-1,
    )


def grad_shape_q1(xi):
    """Reference-space gradients dN_i/d(xi,eta), shape (..., 2, 4)."""
    x, e = xi[..., 0], xi[..., 1]
    gxi = torch.stack(
        [-0.25 * (1.0 - e), -0.25 * (1.0 + e), 0.25 * (1.0 + e), 0.25 * (1.0 - e)],
        dim=-1,
    )
    geta = torch.stack(
        [-0.25 * (1.0 - x), 0.25 * (1.0 - x), 0.25 * (1.0 + x), -0.25 * (1.0 + x)],
        dim=-1,
    )
    return torch.stack([gxi, geta], dim=-2)


def grad_shape_physical(gni, el_coords):
    """Physical gradients dN/dx and detJ from reference gradients + coords.

    gni: (..., 2, 4) reference gradients; el_coords: (..., 4, 2) corner
    coords (broadcast against each other). Returns (gnx (..., 2, 4),
    detJ (...,)).
    """
    jac = gni @ el_coords  # Jac[c][d] = sum_i GNi[c][i] * coords[i][d]
    det = jac[..., 0, 0] * jac[..., 1, 1] - jac[..., 0, 1] * jac[..., 1, 0]
    inv = (
        torch.stack(
            [
                torch.stack([jac[..., 1, 1], -jac[..., 0, 1]], dim=-1),
                torch.stack([-jac[..., 1, 0], jac[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        )
        / det[..., None, None]
    )
    return inv @ gni, det


def element_stiffness(el_coords, coeff=None):
    """8x8 element stiffness of the 2D vector-Laplace/"stress" operator.

    Ke = sum_p B_p^T diag(2,2,1)*w_p*detJ_p*coeff_p B_p with the 3x8
    strain-displacement matrix B. Batched over the leading dims of
    el_coords (..., 4, 2); returns (..., 8, 8) on el_coords' device.
    """
    with span("FEElementMatrices"):
        dtype, device = el_coords.dtype, el_coords.device
        xi, w = gauss_quadrature_q1(dtype, device)
        if coeff is None:
            coeff = torch.ones((GAUSS_POINTS,), dtype=dtype, device=device)
        gni = grad_shape_q1(xi)  # (gp, 2, 4)
        gnx, det = grad_shape_physical(gni, el_coords[..., None, :, :])
        # gnx: (..., gp, 2, 4 nodes); det: (..., gp)
        z = torch.zeros_like(gnx[..., 0, :])
        dx, dy = gnx[..., 0, :], gnx[..., 1, :]

        def interleave(a, b):
            # (..., 4), (..., 4) -> (..., 8) as [a0, b0, a1, b1, ...]
            return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], 8)

        B = torch.stack(
            [interleave(dx, z), interleave(z, dy), interleave(dy, dx)], dim=-2
        )  # (..., gp, 3, 8)
        fac = w * det * coeff  # (..., gp)
        tilde_d = fac[..., None] * torch.tensor([2.0, 2.0, 1.0], dtype=dtype, device=device)
        # sum over (gauss point, strain row) as one (8 x 12) @ (12 x 8) product
        lead = B.shape[:-3]
        Bd = (B * tilde_d[..., None]).reshape(*lead, GAUSS_POINTS * 3, 8)
        return Bd.transpose(-1, -2) @ B.reshape(*lead, GAUSS_POINTS * 3, 8)


def element_rhs(el_coords, body_force):
    """Element load vector Fe (..., 8) with Fe[2i+c] = sum_p w*detJ*N_i*f_c.

    `body_force(x)` maps physical coords (..., 2) -> (..., 2); Gauss points
    are mapped to physical space through the Q1 isoparametric map.
    """
    with span("FEElementRHS"):
        dtype, device = el_coords.dtype, el_coords.device
        xi, w = gauss_quadrature_q1(dtype, device)
        ni = shape_q1(xi)  # (gp, 4)
        gni = grad_shape_q1(xi)
        _, det = grad_shape_physical(gni, el_coords[..., None, :, :])  # (..., gp)
        xp = ni @ el_coords  # physical gauss coords (..., gp, 2)
        fp = body_force(xp)  # (..., gp, 2)
        fac = w * det  # (..., gp)
        fe = ni.transpose(0, 1) @ (fac[..., None] * fp)  # (..., 4, 2)
        return fe.reshape(*fe.shape[:-2], 8)


def default_body_force(x):
    """Constant body force f = (1, 2)."""
    f = torch.tensor([1.0, 2.0], dtype=x.dtype, device=x.device)
    return f.expand(*x.shape[:-1], 2)


def trig_body_force(x):
    """Non-constant body force f = (sin(pi x) cos(pi y), 2), which makes the
    constrained (saddle) solve non-trivial."""
    fx = torch.sin(math.pi * x[..., 0]) * torch.cos(math.pi * x[..., 1])
    fy = torch.full_like(fx, 2.0)
    return torch.stack([fx, fy], dim=-1)


BODY_FORCES = {"constant": default_body_force, "trig": trig_body_force}


def uniform_node_coords(nex, ney, dtype=torch.float64, device=None, extent=(1.0, 1.0)):
    """Node coordinates of a uniform (nex x ney)-element grid on [0,Lx]x[0,Ly].

    Returns (ney+1, nex+1, 2), coords[j, i] = (x_i, y_j).
    """
    xs = torch.linspace(0.0, extent[0], nex + 1, dtype=dtype, device=device)
    ys = torch.linspace(0.0, extent[1], ney + 1, dtype=dtype, device=device)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([X, Y], dim=-1)


def element_corner_coords(node_coords):
    """Per-element corner coords (ney, nex, 4, 2), CCW from lower-left:
    n0=(i,j), n1=(i,j+1), n2=(i+1,j+1), n3=(i+1,j)."""
    c00 = node_coords[:-1, :-1]
    c10 = node_coords[1:, :-1]
    c11 = node_coords[1:, 1:]
    c01 = node_coords[:-1, 1:]
    return torch.stack([c00, c10, c11, c01], dim=-2)


def element_eqnums(nex, ney, nx_nodes=None, device=None):
    """Global equation numbers per element, (ney, nex, 8) int64.

    Natural ordering: node (i, j) -> j * nx_nodes + i, dofs interleaved,
    eqn = node * 2 + c; corners CCW from the lower left as in
    element_corner_coords.
    """
    if nx_nodes is None:
        nx_nodes = nex + 1
    ei = torch.arange(nex, dtype=torch.int64, device=device)
    ej = torch.arange(ney, dtype=torch.int64, device=device)
    J, I = torch.meshgrid(ej, ei, indexing="ij")  # (ney, nex)
    n0 = J * nx_nodes + I
    n1 = (J + 1) * nx_nodes + I
    n2 = (J + 1) * nx_nodes + (I + 1)
    n3 = J * nx_nodes + (I + 1)
    nodes = torch.stack([n0, n1, n2, n3], dim=-1)  # (ney, nex, 4)
    eq = torch.stack([nodes * 2, nodes * 2 + 1], dim=-1)  # (ney, nex, 4, 2)
    return eq.reshape(ney, nex, 8)


def batched_element_matrices(node_coords, nex, ney, coeff=None):
    """All element stiffness matrices of a structured grid, (ney, nex, 8, 8)."""
    if node_coords.shape[:2] != (ney + 1, nex + 1):
        raise ValueError(
            f"node_coords {tuple(node_coords.shape)} do not match a "
            f"{nex}x{ney}-element grid"
        )
    return element_stiffness(element_corner_coords(node_coords), coeff)
