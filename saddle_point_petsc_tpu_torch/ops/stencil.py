"""Structured-grid stencil operator (PyTorch twin of
`saddle_point_petsc_tpu.ops.stencil`).

For a 2D grid with a box stencil of width 1 and 2 dof per node, every node
row is a 3x3 neighbourhood of 2x2 blocks. The operator is stored as
coefficient *planes* (4, 3, 3, ny, nx), plane p = 2*c + d for row dof c
and column dof d, with the grid's x-dimension last. Vectors are dof-major
fields (2, ny, nx). A matvec is 36 multiply-adds per node over shifted
windows of the field: no index arrays and no gathers.

`planes_matvec_padded` / `planes_matvec_field` are the plain PyTorch
versions of kernel B1 (`ops/cuda/spmv.py`, `csrc/stencil_spmv.cu`), and
`planes_matmat_field` that of kernel B2, the SpMM over a batch of k fields
(`ops/cuda/spmm.py`, `csrc/stencil_spmm.cu`). `StencilOperator` sends a
CPU tensor to them and a CUDA tensor to the kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# Element-local node offsets (dj, di), CCW from lower-left.
_NODE_OFF = ((0, 0), (1, 0), (1, 1), (0, 1))


def block_to_planes(W):
    """(ny, nx, 3, 3, 2, 2) block layout -> (4, 3, 3, ny, nx) planes."""
    ny, nx = W.shape[:2]
    return W.permute(4, 5, 2, 3, 0, 1).reshape(4, 3, 3, ny, nx).contiguous()


def planes_to_block(planes):
    """(4, 3, 3, ny, nx) planes -> (ny, nx, 3, 3, 2, 2) block layout."""
    ny, nx = planes.shape[-2:]
    return planes.reshape(2, 2, 3, 3, ny, nx).permute(4, 5, 2, 3, 0, 1)


def planes_matvec_padded(planes, xpT):
    """y[c] = sum_{dj,di,d} planes[2c+d, dj, di] * xpT[d] windows.

    planes: (4, 3, 3, ny, nx); xpT: (..., 2, ny+2, nx+2) halo-padded
    dof-major fields, any leading batch axes. Returns (..., 2, ny, nx).
    Sums in kernel B1's order: dj, then di, then d; every operation is
    elementwise, so each field of a batch gets the bits it gets alone.
    """
    ny, nx = planes.shape[-2:]
    y0 = torch.zeros((*xpT.shape[:-3], ny, nx), dtype=xpT.dtype, device=xpT.device)
    y1 = y0
    for dj in range(3):
        for di in range(3):
            w0 = xpT[..., 0, dj : dj + ny, di : di + nx]
            w1 = xpT[..., 1, dj : dj + ny, di : di + nx]
            y0 = y0 + planes[0, dj, di] * w0 + planes[1, dj, di] * w1
            y1 = y1 + planes[2, dj, di] * w0 + planes[3, dj, di] * w1
    return torch.stack([y0, y1], dim=-3)


def planes_matvec_field(planes, xT):
    """Matvec on a dof-major (2, ny, nx) field with a zero boundary."""
    return planes_matvec_padded(planes, F.pad(xT, (1, 1, 1, 1)))


def planes_matmat_field(planes, XT):
    """SpMM on a batch of k dof-major fields with a zero boundary:
    (k, 2, ny, nx) -> (k, 2, ny, nx). Column j has the bits of
    planes_matvec_field(planes, XT[j])."""
    return planes_matvec_padded(planes, F.pad(XT, (1, 1, 1, 1)))


def field_to_flat(xT):
    """(2, ny, nx) dof-major field -> natural interleaved flat vector
    (row = (j*nx + i)*2 + c, the PETSc/CSR ordering)."""
    return xT.permute(1, 2, 0).reshape(-1)


def flat_to_field(x, ny, nx):
    """Natural interleaved flat vector -> (2, ny, nx) dof-major field."""
    return x.reshape(ny, nx, 2).permute(2, 0, 1)


def field_to_nodes(xT):
    """(2, ny, nx) -> (ny, nx, 2) node-major view (IO/geometry)."""
    return xT.permute(1, 2, 0)


def nodes_to_field(x):
    """(ny, nx, 2) node-major -> (2, ny, nx) dof-major."""
    return x.permute(2, 0, 1)


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """3x3-block-stencil operator on an (ny, nx) node grid with 2 dof/node.

    Storage is the planes layout (4, 3, 3, ny, nx); vectors are dof-major
    (2, ny, nx) fields. The matvec and the SpMM go by device alone: planes
    on the CPU take the plain PyTorch versions, planes on a CUDA device
    take kernels B1 and B2.
    """

    planes: torch.Tensor  # (4, 3, 3, ny, nx)
    # the global (row, column) of the first node: a serial grid is whole
    origin = (0, 0)

    @staticmethod
    def from_block(W):
        return StencilOperator(block_to_planes(W))

    @property
    def W(self):
        """Block-layout view (ny, nx, 3, 3, 2, 2)."""
        return planes_to_block(self.planes)

    @property
    def grid_shape(self):
        return tuple(self.planes.shape[-2:])

    @property
    def n(self):
        ny, nx = self.grid_shape
        return ny * nx * 2

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def nnz(self):
        """Number of stored (stencil) entries, the bandwidth-relevant count."""
        return self.planes.numel()

    def pad(self, x):
        """(..., ny, nx) -> (..., ny+2, nx+2): x with its ring of zero
        (Dirichlet) ghosts."""
        return F.pad(x, (1, 1, 1, 1))

    def matvec_field(self, xT):
        """(2, ny, nx) -> (2, ny, nx)."""
        from saddle_point_petsc_tpu_torch.ops.cuda.spmv import stencil_spmv

        return stencil_spmv(self.planes, xT.contiguous())

    def matvec(self, xflat):
        """Natural-ordering flat matvec (interop/tests)."""
        ny, nx = self.grid_shape
        return field_to_flat(self.matvec_field(flat_to_field(xflat, ny, nx)))

    def matmat_field(self, XT):
        """SpMM on a batch of fields, (k, 2, ny, nx) -> (k, 2, ny, nx)."""
        from saddle_point_petsc_tpu_torch.ops.cuda.spmm import stencil_spmm

        return stencil_spmm(self.planes, XT.contiguous())

    def matmat(self, X):
        """Y = A X for dense X (n, k) in the natural flat ordering."""
        ny, nx = self.grid_shape
        k = X.shape[1]
        XT = X.T.reshape(k, ny, nx, 2).permute(0, 3, 1, 2)
        return self.matmat_field(XT).permute(0, 2, 3, 1).reshape(k, -1).T

    def __call__(self, x):
        if x.ndim == 1:
            return self.matvec(x)
        return self.matvec_field(x)

    def diag_blocks(self):
        """Dense diagonal 2x2 blocks, shape (ny, nx, 2, 2)."""
        d = self.planes[:, 1, 1]  # (4, ny, nx)
        return d.reshape(2, 2, *d.shape[1:]).permute(2, 3, 0, 1)

    def diagonal(self):
        """diag(A) as a (2, ny, nx) field."""
        return torch.stack([self.planes[0, 1, 1], self.planes[3, 1, 1]])


def assemble_stencil(Ke):
    """Accumulate batched element matrices into node-stencil form.

    Ke: (ney, nex, 8, 8) element matrices, (node, dof)-interleaved.
    Returns W: (ney+1, nex+1, 3, 3, 2, 2): 16 strided-slice adds, one per
    (row node, column node) pair of the element.
    """
    ney, nex = Ke.shape[:2]
    Kb = Ke.reshape(ney, nex, 4, 2, 4, 2)
    W = torch.zeros((ney + 1, nex + 1, 3, 3, 2, 2), dtype=Ke.dtype, device=Ke.device)
    for a, (aj, ai) in enumerate(_NODE_OFF):
        for b, (bj, bi) in enumerate(_NODE_OFF):
            sj, si = bj - aj + 1, bi - ai + 1
            # in place: W is a fresh accumulator owned by this function
            W[aj : aj + ney, ai : ai + nex, sj, si] += Kb[:, :, a, :, b, :]
    return W


def boundary_mask(ny, nx, device=None):
    """True at boundary nodes (i==0, i==nx-1, j==0, j==ny-1)."""
    j = torch.arange(ny, device=device)[:, None]
    i = torch.arange(nx, device=device)[None, :]
    return (i == 0) | (i == nx - 1) | (j == 0) | (j == ny - 1)


def stencil_zero_rows_columns(W, mask, diag=1.0):
    """Symmetric Dirichlet elimination in stencil form.

    Zeros every block whose row node OR column node is masked, then sets
    the masked diagonal blocks to diag*I (MatZeroRowsColumns): the
    operator stays symmetric.
    """
    ny, nx = W.shape[:2]
    W = torch.where(mask[:, :, None, None, None, None], 0.0, W)
    # columns: entry (j,i,dj,di) couples to node (j+dj-1, i+di-1)
    maskp = F.pad(mask, (1, 1, 1, 1))
    for dj in range(3):
        for di in range(3):
            keep = torch.where(maskp[dj : dj + ny, di : di + nx], 0.0, 1.0).to(W.dtype)
            # in place: W is the fresh tensor made by torch.where above
            W[:, :, dj, di] *= keep[:, :, None, None]
    eye = diag * torch.eye(2, dtype=W.dtype, device=W.device)
    W[:, :, 1, 1] = torch.where(mask[:, :, None, None], eye, W[:, :, 1, 1])
    return W


def stencil_to_coo(W):
    """Stencil -> numpy COO triplets (rows, cols, vals); out-of-grid entries
    are padding with row = col = -1 and value 0 (setup/viewer use)."""
    W = W.detach().cpu().numpy()
    ny, nx = W.shape[:2]
    j = np.arange(ny, dtype=np.int64)[:, None]
    i = np.arange(nx, dtype=np.int64)[None, :]
    rows_list, cols_list, vals_list = [], [], []
    for dj in range(3):
        for di in range(3):
            nj, ni = j + dj - 1, i + di - 1
            inb = (nj >= 0) & (nj < ny) & (ni >= 0) & (ni < nx)
            rnode = j * nx + i
            cnode = np.where(inb, nj * nx + ni, 0)
            blk = W[:, :, dj, di]  # (ny, nx, 2, 2)
            for c in range(2):
                for d in range(2):
                    rows_list.append(np.where(inb, rnode * 2 + c, -1).reshape(-1))
                    cols_list.append(np.where(inb, cnode * 2 + d, -1).reshape(-1))
                    vals_list.append(np.where(inb, blk[:, :, c, d], 0.0).reshape(-1))
    return (
        np.concatenate(rows_list),
        np.concatenate(cols_list),
        np.concatenate(vals_list),
    )
