"""Sparse matrix formats (PyTorch twin of `saddle_point_petsc_tpu.ops.sparse`).

COO triplets with duplicate summation (MatSetValues ADD_VALUES), CSR and
BSR storage (MATAIJ, MATBAIJ), ELL, banded DIA and block-DIA, their
matvecs and matmats, the conversions between them, and the symmetric
Dirichlet elimination (MatZeroRowsColumns).

Containers are frozen dataclasses of tensors; index arrays are int64.
COO -> CSR runs on the tensors' device with the JAX package's static
sizes (sort, deduplicate, keep the padding at the tail); `csr_compact`
and the conversions to BSR, DIA and block-DIA run on the host with scipy
at setup time and return tensors on the input's device.

The ELL, DIA and block-DIA matvecs and the DIA matmat go by device alone:
CPU tensors take the plain versions, CUDA tensors kernels B5, B3, B4 and
B6 (`ops/cuda/ell.py`, `ops/cuda/dia.py`, `ops/cuda/bdia.py`,
`ops/cuda/dia_spmm.py`). There is no backend switch, so the JAX CLI's
`-mat_dia_backend` and `-mat_bdia_backend` have no counterpart. Sums run
in the JAX package's order: segment sums in entry order (on the CPU; on a
CUDA device `torch.segment_reduce` rounds otherwise, by ulps), DIA bands
in offset order, block-DIA triples in `active` order, ELL slots in slot
order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from saddle_point_petsc_tpu_torch.ops.cuda.bdia import bdia_spmv_2d
from saddle_point_petsc_tpu_torch.ops.cuda.dia import dia_spmv_2d
from saddle_point_petsc_tpu_torch.ops.cuda.dia_spmm import dia_spmm
from saddle_point_petsc_tpu_torch.ops.cuda.ell import ell_spmv
from saddle_point_petsc_tpu_torch.utils.device import resolve_device


def _row_sums(vals, indptr):
    """Sums over the rows of a CSR-ordered (nnz, ...) tensor: row i adds
    entries indptr[i]:indptr[i+1] from 0, in entry order on the CPU (an
    empty row sums to 0; padding past indptr[-1] is left out). No host
    sync."""
    return torch.segment_reduce(vals, "sum", offsets=indptr, axis=0, unsafe=True)


@dataclasses.dataclass(frozen=True)
class COO:
    """Triplet format; duplicates allowed (summed on conversion).

    Entries with row < 0 are padding and are dropped.
    """

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float
    shape: tuple  # (m, n)

    @property
    def nnz(self):
        return self.rows.shape[0]

    def todense(self):
        m, n = self.shape
        valid = self.rows >= 0
        out = torch.zeros((m, n), dtype=self.vals.dtype, device=self.vals.device)
        out.index_put_((self.rows[valid], self.cols[valid]), self.vals[valid], accumulate=True)
        return out


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row. Padding entries sit after indptr[-1] with
    col == -1 (value ignored); column indices within a row are sorted."""

    indptr: torch.Tensor  # (m+1,) int64
    cols: torch.Tensor  # (nnz,) int64 (-1 padding)
    vals: torch.Tensor  # (nnz,) float
    shape: tuple

    @property
    def nnz(self):
        return self.cols.shape[0]

    def todense(self):
        m, n = self.shape
        rows = row_ids_from_indptr(self.indptr, self.nnz)
        valid = self.cols >= 0
        out = torch.zeros((m, n), dtype=self.vals.dtype, device=self.vals.device)
        out.index_put_((rows[valid], self.cols[valid]), self.vals[valid], accumulate=True)
        return out

    def matvec(self, x):
        return csr_matvec(self, x)

    def matmat(self, X):
        return csr_matmat(self, X)

    def __call__(self, x):
        return self.matvec(x)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block CSR with dense b x b blocks. Block row i covers scalar rows
    [i*b, (i+1)*b); padding block columns are -1."""

    indptr: torch.Tensor  # (mb+1,) int64
    cols: torch.Tensor  # (nnzb,) int64 block columns (-1 padding)
    vals: torch.Tensor  # (nnzb, b, b)
    shape: tuple  # scalar (m, n)
    block: int = 2

    @property
    def nnzb(self):
        return self.cols.shape[0]

    def todense(self):
        m, n = self.shape
        b = self.block
        rows = row_ids_from_indptr(self.indptr, self.nnzb)
        valid = self.cols >= 0
        out = torch.zeros((m // b, n // b, b, b), dtype=self.vals.dtype, device=self.vals.device)
        out.index_put_((rows[valid], self.cols[valid]), self.vals[valid], accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(m, n)

    def matvec(self, x):
        return bsr_matvec(self, x)

    def matmat(self, X):
        return bsr_matmat(self, X)

    def __call__(self, x):
        return self.matvec(x)


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: a fixed number of entries per row, padded with col == -1.
    cols and vals have shape (m, k). Construction also stores the
    slot-major copy kernel B5 reads, `ell_transpose`'s (k, m) int32 cols_t
    and vals_t, so no matvec transposes."""

    cols: torch.Tensor  # (m, k) int64
    vals: torch.Tensor  # (m, k)
    shape: tuple
    cols_t: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    vals_t: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        cols_t, vals_t = ell_transpose(self)
        object.__setattr__(self, "cols_t", cols_t)  # frozen: set once, here
        object.__setattr__(self, "vals_t", vals_t)

    def todense(self):
        m, n = self.shape
        r = torch.arange(m, device=self.cols.device)[:, None].expand(self.cols.shape)
        valid = self.cols >= 0
        out = torch.zeros((m, n), dtype=self.vals.dtype, device=self.vals.device)
        out.index_put_((r[valid], self.cols[valid]), self.vals[valid], accumulate=True)
        return out

    def matvec(self, x):
        return ell_matvec(self, x)

    def matmat(self, X):
        return ell_matmat(self, X)

    def __call__(self, x):
        return self.matvec(x)


def row_ids_from_indptr(indptr, nnz):
    """Row of every entry of a CSR with `nnz` entries (padding -> last row)."""
    m = indptr.shape[0] - 1
    e = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, e, right=True) - 1).clamp(0, max(m - 1, 0))


# ---------------------------------------------------------------------------
# Assembly: COO -> CSR on the device, with the JAX package's static sizes
# ---------------------------------------------------------------------------


def coo_sum_duplicates(coo: COO) -> COO:
    """Sort triplets by (row, col) and sum duplicates.

    The result keeps the same nnz; live entries come first in (row, col)
    order and the collapsed slots become padding (row = col = -1, value 0)
    at the tail. Duplicates are summed in their input order.
    """
    m, n = coo.shape
    nnz = coo.nnz
    rows, cols = coo.rows.long(), coo.cols.long()
    if nnz == 0:
        return COO(rows, cols, coo.vals, coo.shape)
    key_rows = torch.where(rows < 0, m, rows)  # padding sorts last
    key = key_rows * (n + 2) + (cols.clamp_min(-1) + 1)
    order = torch.sort(key, stable=True).indices
    r, c, v = rows[order], cols[order], coo.vals[order]
    first = torch.ones(nnz, dtype=torch.bool, device=r.device)
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    starts = torch.nonzero(first).reshape(-1)
    ngroups = starts.shape[0]
    ur = torch.full((nnz,), -1, dtype=torch.int64, device=r.device)
    uc = torch.full((nnz,), -1, dtype=torch.int64, device=r.device)
    summed = torch.zeros((nnz,), dtype=v.dtype, device=v.device)
    ur[:ngroups], uc[:ngroups] = r[starts], c[starts]
    summed[:ngroups] = _row_sums(v, torch.cat([starts, starts.new_tensor([nnz])]))
    pad = (ur >= m) | (ur < 0)
    return COO(
        torch.where(pad, -1, ur),
        torch.where(pad, -1, uc),
        torch.where(pad, torch.zeros_like(summed), summed),
        coo.shape,
    )


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR with duplicate summation on the device (static nnz;
    padding stays at the tail, outside indptr)."""
    m, _ = coo.shape
    dedup = coo_sum_duplicates(coo)
    r = dedup.rows
    counts = torch.bincount(r[r >= 0], minlength=m)
    indptr = torch.zeros((m + 1,), dtype=torch.int64, device=r.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CSR(indptr, dedup.cols, dedup.vals, coo.shape)


def csr_compact(csr: CSR) -> CSR:
    """Shrink a padded CSR to its exact nnz (host round trip, setup time)."""
    nnz = int(csr.indptr[-1])
    return CSR(csr.indptr, csr.cols[:nnz].clone(), csr.vals[:nnz].clone(), csr.shape)


def csr_to_ell(csr: CSR, k: int | None = None) -> ELL:
    """CSR -> ELL of width k (default: the longest row)."""
    m, _ = csr.shape
    if k is None:
        k = int(torch.diff(csr.indptr).max()) if m else 0
    rows = row_ids_from_indptr(csr.indptr, csr.nnz)
    pos = torch.arange(csr.nnz, device=rows.device) - csr.indptr[rows]
    valid = (csr.cols >= 0) & (pos < k)
    cols = torch.full((m, k), -1, dtype=torch.int64, device=rows.device)
    vals = torch.zeros((m, k), dtype=csr.vals.dtype, device=csr.vals.device)
    cols[rows[valid], pos[valid]] = csr.cols[valid]
    vals[rows[valid], pos[valid]] = csr.vals[valid]
    return ELL(cols, vals, csr.shape)


def csr_to_scipy(csr: CSR):
    """CSR -> scipy.sparse.csr_matrix on the host (padding dropped)."""
    import scipy.sparse as sps

    indptr = csr.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    return sps.csr_matrix(
        (csr.vals[:nnz].cpu().numpy(), csr.cols[:nnz].cpu().numpy(), indptr),
        shape=csr.shape,
    )


def scipy_to_csr(a, device=None, dtype=None) -> CSR:
    """scipy sparse -> CSR (sorted indices) on `device` (None: the CUDA
    card, see utils/device.py)."""
    device = resolve_device(device)
    a = a.tocsr()
    a.sort_indices()
    vals = torch.tensor(a.data, device=device)
    return CSR(
        torch.tensor(a.indptr, dtype=torch.int64, device=device),
        torch.tensor(a.indices, dtype=torch.int64, device=device),
        vals if dtype is None else vals.to(dtype),
        tuple(a.shape),
    )


def csr_to_bsr(csr: CSR, block: int = 2) -> BSR:
    """CSR -> BSR with b x b blocks (host, setup time)."""
    m, n = csr.shape
    a = csr_to_scipy(csr).tobsr(blocksize=(block, block))
    a.sort_indices()
    dev = csr.vals.device
    return BSR(
        torch.tensor(a.indptr, dtype=torch.int64, device=dev),
        torch.tensor(a.indices, dtype=torch.int64, device=dev),
        torch.tensor(a.data, dtype=csr.vals.dtype, device=dev),
        (m, n),
        block,
    )


def csr_from_numpy(indptr, cols, vals, shape, device=None, dtype=torch.float64) -> CSR:
    """CSR from numpy arrays (for example the JAX package's) on `device`
    (None: the CUDA card)."""
    device = resolve_device(device)
    return CSR(
        torch.tensor(np.asarray(indptr), dtype=torch.int64, device=device),
        torch.tensor(np.asarray(cols), dtype=torch.int64, device=device),
        torch.tensor(np.asarray(vals), dtype=dtype, device=device),
        tuple(int(s) for s in shape),
    )


# ---------------------------------------------------------------------------
# SpMV and SpMM (plain PyTorch; ELL, DIA and block-DIA go to kernels)
# ---------------------------------------------------------------------------


def coo_matvec(coo: COO, x):
    valid = coo.rows >= 0
    y = torch.zeros((coo.shape[0],), dtype=x.dtype, device=x.device)
    return y.index_add_(0, coo.rows[valid], coo.vals[valid] * x[coo.cols[valid]])


def csr_matvec(csr: CSR, x):
    """y = A x: one gather, one product per entry, row sums in entry order."""
    return _row_sums(csr.vals * x[csr.cols.clamp_min(0)], csr.indptr)


def ell_transpose(ell: ELL):
    """(m, k) ELL -> kernel B5's slot-major (k, m) cols_t (int32) and vals_t,
    contiguous (a copy: setup time, done once by the ELL constructor)."""
    if ell.shape[1] > 2**31 - 1:
        raise ValueError(f"ELL with {ell.shape[1]} columns: int32 column indices overflow")
    return ell.cols.T.to(torch.int32).contiguous(), ell.vals.T.contiguous()


def ell_matvec(ell: ELL, x):
    """y = A x through kernel B5 (its plain version for CPU tensors): one
    gather and multiply-add per slot, slots summed in order."""
    return ell_spmv(ell.cols_t, ell.vals_t, x.contiguous())


def bsr_matvec(bsr: BSR, x):
    """y = A x for block CSR: gathered b-vectors, b x b block products,
    block-row sums in entry order."""
    xb = x.reshape(-1, bsr.block)
    yi = (bsr.vals * xb[bsr.cols.clamp_min(0)][:, None, :]).sum(-1)  # (nnzb, b)
    return _row_sums(yi, bsr.indptr).reshape(-1)


def coo_matmat(coo: COO, X):
    valid = coo.rows >= 0
    Y = torch.zeros((coo.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    return Y.index_add_(0, coo.rows[valid], coo.vals[valid][:, None] * X[coo.cols[valid]])


def csr_matmat(csr: CSR, X):
    """Y = A X for dense X (n, k)."""
    return _row_sums(csr.vals[:, None] * X[csr.cols.clamp_min(0)], csr.indptr)


def ell_matmat(ell: ELL, X):
    valid = ell.cols >= 0
    v = torch.where(valid, ell.vals, 0.0)
    return torch.sum(v[:, :, None] * X[ell.cols.clamp_min(0)], dim=1)


def bsr_matmat(bsr: BSR, X):
    """Y = A X for block CSR and dense X (n, k)."""
    k = X.shape[1]
    Xb = X.reshape(-1, bsr.block, k)
    Yi = torch.einsum("ecd,edk->eck", bsr.vals, Xb[bsr.cols.clamp_min(0)])
    return _row_sums(Yi, bsr.indptr).reshape(-1, k)


# ---------------------------------------------------------------------------
# Boundary-condition elimination and diagonals
# ---------------------------------------------------------------------------


def coo_zero_rows_columns(coo: COO, mask, diag=1.0) -> COO:
    """Symmetric elimination (MatZeroRowsColumns): zero every entry whose
    row or column is masked, keep the pattern, and append one `diag`
    triplet per masked row (padding, row = -1, for the others)."""
    m, _ = coo.shape
    valid = coo.rows >= 0
    hit = valid & (mask[coo.rows.clamp_min(0)] | mask[coo.cols.clamp_min(0)])
    vals = torch.where(hit, torch.zeros_like(coo.vals), coo.vals)
    ar = torch.arange(m, dtype=torch.int64, device=coo.rows.device)
    diag_rows = torch.where(mask, ar, -1)
    diag_vals = torch.where(
        mask,
        torch.full((m,), diag, dtype=coo.vals.dtype, device=coo.vals.device),
        torch.zeros((m,), dtype=coo.vals.dtype, device=coo.vals.device),
    )
    return COO(
        torch.cat([coo.rows.long(), diag_rows]),
        torch.cat([coo.cols.long(), diag_rows]),
        torch.cat([vals, diag_vals]),
        coo.shape,
    )


def csr_extract_diagonal(csr: CSR):
    """diag(A) as a dense (m,) vector."""
    rows = row_ids_from_indptr(csr.indptr, csr.nnz)
    isdiag = (csr.cols == rows) & (csr.cols >= 0)
    d = torch.zeros((csr.shape[0],), dtype=csr.vals.dtype, device=csr.vals.device)
    return d.index_add_(0, rows[isdiag], csr.vals[isdiag])


def bsr_extract_diag_blocks(bsr: BSR):
    """Dense diagonal blocks (mb, b, b)."""
    rows = row_ids_from_indptr(bsr.indptr, bsr.nnzb)
    isdiag = (bsr.cols == rows) & (bsr.cols >= 0)
    mb = bsr.shape[0] // bsr.block
    out = torch.zeros((mb, bsr.block, bsr.block), dtype=bsr.vals.dtype, device=bsr.vals.device)
    return out.index_add_(0, rows[isdiag], bsr.vals[isdiag])


# ---------------------------------------------------------------------------
# DIA (diagonal/banded) format, kernel B3
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DIA:
    """Row-indexed diagonal storage: data[k, i] = A[i, i + offsets[k]].

    The matvec is a sum of products with shifted x: no index arrays.
    Banded FEM matrices store well this way; others after RCM reordering.
    `nnz` counts the stored band values, padding included.
    """

    data: torch.Tensor  # (ndiag, n)
    offsets: tuple  # Python ints, ascending for csr_to_dia's output
    shape: tuple

    @property
    def nnz(self):
        return self.data.numel()

    def todense(self):
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.data.dtype, device=self.data.device)
        i = torch.arange(m, device=self.data.device)
        for k, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < n)
            out[i[valid], i[valid] + off] += self.data[k][valid]
        return out

    def matvec(self, x):
        return dia_matvec(self, x)

    def matmat(self, X):
        return dia_matmat(self, X)

    def __call__(self, x):
        return self.matvec(x)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros((self.shape[0],), dtype=self.data.dtype, device=self.data.device)


def dia_from_numpy(data, offsets, shape, device=None, dtype=torch.float64) -> DIA:
    """DIA from numpy bands data (ndiag, n) and offsets on `device` (None:
    the CUDA card)."""
    device = resolve_device(device)
    return DIA(
        torch.tensor(np.asarray(data), dtype=dtype, device=device),
        tuple(int(o) for o in offsets),
        tuple(int(s) for s in shape),
    )


def csr_to_dia(csr: CSR, rcm_reorder=False):
    """CSR -> DIA (host, setup time); returns (dia, perm).

    With rcm_reorder the matrix is first permuted by reverse Cuthill-McKee
    (the port's native `rcm`, scipy's when it does not load):
    A_perm[i, j] = A[perm[i], perm[j]]. perm is None without it. Structured
    grid matrices are best left in their natural order.
    """
    a = csr_to_scipy(csr)
    perm = None
    if rcm_reorder:
        try:
            from saddle_point_petsc_tpu_torch.utils import native

            perm = native.rcm(a.indptr, a.indices, a.shape[0])
        except Exception:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = reverse_cuthill_mckee(a, symmetric_mode=True)
        a = a[perm][:, perm].tocsr()
    d = a.todia()
    offsets = tuple(int(o) for o in d.offsets)
    n = a.shape[0]
    # scipy stores data[k, j] = A[j - off, j] (column-indexed); shift each
    # band to the row-indexed data[k, i] = A[i, i + off]
    data = np.zeros((len(offsets), n), d.data.dtype)
    for k, off in enumerate(offsets):
        if off >= 0:
            data[k, : n - off] = d.data[k, off:n]
        else:
            data[k, -off:] = d.data[k, : n + off]
    dia = DIA(torch.tensor(data, dtype=csr.vals.dtype, device=csr.vals.device), offsets, a.shape)
    return dia, perm


def dia_to_scipy(dia: DIA):
    """Row-indexed DIA -> scipy csr_matrix, the inverse of csr_to_dia's shift."""
    import scipy.sparse as sps

    m, n = dia.shape
    data = dia.data.detach().cpu().numpy().astype(np.float64)
    sdata = np.zeros_like(data)
    for k, off in enumerate(dia.offsets):
        if off >= 0:
            sdata[k, off:] = data[k, : n - off] if off else data[k]
        else:
            sdata[k, : n + off] = data[k, -off:]
    return sps.dia_matrix((sdata, dia.offsets), shape=(m, n)).tocsr()


def dia_matvec(dia: DIA, x):
    """y = A x through kernel B3 (its plain version for CPU tensors)."""
    return dia_spmv_2d(dia.data, x.contiguous(), dia.offsets)


def dia_matmat(dia: DIA, X):
    """Y = A X for dense X (n, k) of any strides (the transpose of a (k, n)
    batch among them, without a copy) through kernel B6 (its plain
    version, shifted row slices of X, for CPU tensors)."""
    return dia_spmm(dia.data, X, dia.offsets)


# ---------------------------------------------------------------------------
# Block-DIA: BSR blocks stored by block diagonal, kernel B4
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BDIA:
    """Block-diagonal storage: data[k, :, :, i] = block A[i, i + offsets[k]]
    (block indices, row-indexed like DIA), with the block-row axis last.

    offsets: block offsets; shape: scalar (m, n), m = mb * b; active: the
    (k, c, d) triples whose band holds nonzeros (empty = all of them).
    """

    data: torch.Tensor  # (ndiag, b, b, mb)
    offsets: tuple
    shape: tuple
    block: int = 2
    active: tuple = ()

    @property
    def nnz(self):
        return self.data.numel()

    def todense(self):
        m, n = self.shape
        b = self.block
        mb, nb = m // b, n // b
        out = torch.zeros((mb, nb, b, b), dtype=self.data.dtype, device=self.data.device)
        i = torch.arange(mb, device=self.data.device)
        for k, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < nb)
            blk = self.data[k].permute(2, 0, 1)  # (mb, b, b)
            out[i[valid], i[valid] + off] += blk[valid]
        return out.permute(0, 2, 1, 3).reshape(m, n)

    def matvec(self, x):
        return bdia_matvec(self, x)

    def matmat(self, X):
        return bdia_matmat(self, X)

    def __call__(self, x):
        return self.matvec(x)

    def diagonal(self):
        if 0 in self.offsets:
            blk = self.data[self.offsets.index(0)]  # (b, b, mb)
            return torch.diagonal(blk, dim1=0, dim2=1).reshape(-1)  # (mb, b) -> flat
        return torch.zeros((self.shape[0],), dtype=self.data.dtype, device=self.data.device)


def bdia_from_numpy(data, offsets, shape, block=2, active=(), device=None,
                    dtype=torch.float64) -> BDIA:
    """BDIA from numpy block bands data (ndiag, b, b, mb) on `device`
    (None: the CUDA card)."""
    device = resolve_device(device)
    return BDIA(
        torch.tensor(np.asarray(data), dtype=dtype, device=device),
        tuple(int(o) for o in offsets),
        tuple(int(s) for s in shape),
        int(block),
        tuple(tuple(int(v) for v in t) for t in active),
    )


def bsr_to_bdia(bsr: BSR, max_diag_blowup=4.0, max_diags=256) -> BDIA:
    """BSR -> block-DIA (host, setup time). Raises ValueError when the
    block bands would store more than `max_diag_blowup` x the block nnz."""
    indptr = bsr.indptr.cpu().numpy()
    cols = bsr.cols.cpu().numpy()
    vals = bsr.vals.detach().cpu().numpy()
    mb = bsr.shape[0] // bsr.block
    rows = np.repeat(np.arange(mb), np.diff(indptr))
    live = cols[: len(rows)] >= 0
    r, c, v = rows[live], cols[: len(rows)][live], vals[: len(rows)][live]
    offs = np.unique(c.astype(np.int64) - r)
    if len(offs) > max_diags or len(offs) * mb > max_diag_blowup * max(len(r), 1):
        raise ValueError(
            f"bsr_to_bdia: {len(offs)} block bands x {mb} block rows "
            f"exceeds {max_diag_blowup}x the block nnz ({len(r)})"
        )
    b = bsr.block
    data = np.zeros((len(offs), b, b, mb), vals.dtype)
    d_idx = np.searchsorted(offs, c.astype(np.int64) - r)
    data[d_idx, :, :, r] = v
    active = tuple(
        (int(k), int(cc), int(dd))
        for k in range(len(offs))
        for cc in range(b)
        for dd in range(b)
        if np.any(data[k, cc, dd] != 0)
    )
    return BDIA(
        torch.tensor(data, dtype=bsr.vals.dtype, device=bsr.vals.device),
        tuple(int(o) for o in offs),
        bsr.shape,
        b,
        active,
    )


def _bdia_active(bdia: BDIA):
    b = bdia.block
    return bdia.active or tuple(
        (k, c, d) for k in range(len(bdia.offsets)) for c in range(b) for d in range(b)
    )


def bdia_matvec_dofmajor(bdia: BDIA, xb):
    """y = A x on a dof-major (b, mb) vector through kernel B4 (its plain
    version for CPU tensors). xb must be contiguous."""
    return bdia_spmv_2d(bdia.data, xb, bdia.offsets, _bdia_active(bdia))


def bdia_matvec(bdia: BDIA, x):
    """y = A x for a flat dof-interleaved x: copies to dof-major, applies
    the kernel, and copies back."""
    b = bdia.block
    mb = bdia.shape[0] // b
    xb = x.reshape(mb, b).T.contiguous()  # explicit copy to dof-major (b, mb)
    return bdia_matvec_dofmajor(bdia, xb).T.reshape(-1)


def bdia_matmat(bdia: BDIA, X):
    """Y = A X for dense X (n, k): shifted block products, dof-major."""
    b = bdia.block
    mb = bdia.shape[0] // b
    Xb = X.reshape(mb, b, X.shape[1]).permute(1, 2, 0)  # (b, k, mb)
    Y = torch.zeros_like(Xb)
    for k, off in enumerate(bdia.offsets):
        blk = bdia.data[k]  # (b, b, mb)
        if abs(off) >= mb:
            continue
        if off == 0:
            Y = Y + torch.einsum("cdi,dki->cki", blk, Xb)
        elif off > 0:
            Y[:, :, : mb - off] += torch.einsum("cdi,dki->cki", blk[:, :, : mb - off], Xb[:, :, off:])
        else:
            Y[:, :, -off:] += torch.einsum("cdi,dki->cki", blk[:, :, -off:], Xb[:, :, : mb + off])
    return Y.permute(2, 0, 1).reshape(bdia.shape[0], -1)


def to_scipy(A):
    """CSR, DIA or block-DIA -> scipy csr_matrix in float64 (host)."""
    import scipy.sparse as sps

    if isinstance(A, CSR):
        return csr_to_scipy(A).astype(np.float64)
    if isinstance(A, DIA):
        return dia_to_scipy(A)
    if isinstance(A, BDIA):
        b, (m, n) = A.block, A.shape
        mb = m // b
        data = A.data.detach().cpu().numpy().astype(np.float64)
        rows, cols, vals = [], [], []
        i = np.arange(mb)
        for k, c, d in _bdia_active(A):
            off = A.offsets[k]
            ok = (i + off >= 0) & (i + off < n // b)
            rows.append(i[ok] * b + c)
            cols.append((i[ok] + off) * b + d)
            vals.append(data[k, c, d, ok])
        cat = (lambda p: np.concatenate(p)) if rows else (lambda p: np.zeros(0))
        return sps.csr_matrix((cat(vals), (cat(rows), cat(cols))), shape=(m, n))
    raise TypeError(f"to_scipy: unsupported operator {type(A).__name__}")
