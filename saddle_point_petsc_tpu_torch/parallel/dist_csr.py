"""Row-partitioned distributed general sparse matrix, MATMPIAIJ (PyTorch
twin of `saddle_point_petsc_tpu.parallel.dist_csr`).

PETSc's MatMPIAIJ stores each rank's rows as two local blocks, the
"diagonal" block (the columns the rank owns) and the "off-diagonal" block
(every other column), plus a VecScatter that ships exactly the ghost
entries each MatMult needs. The JAX package holds one global array per
field sharded over a 1-D mesh under shard_map; the port is SPMD over
processes (parallel/mesh.py): rows are block-partitioned over a (1, world)
`ProcessMesh`, and each rank holds its n_loc = n_pad / world rows:

- the diag block as slot-major ELL (kd, n_loc) with LOCAL column ids,
  kernel B5's layout (ops/cuda/ell.py);
- the off-diag block as slot-major ELL (ko, n_loc) whose ids index the
  ghost buffer;
- its row of the send plan, `send_idx` (world, max_send): the local index
  of the t-th entry it ships to rank d is send_idx[d, t];
- where the band test passes, the banded copy of its diag block,
  `dia_data` (ndiag, n_loc), kernel B3's and B6's layout.

The VecScatter, the JAX package's `lax.all_to_all` of a (ndev, max_send)
buffer, is one all_to_all with equal splits (`ProcessMesh.all_to_all`):
ghost slot s * max_send + t on this rank holds x_s[send_idx_s[rank, t]],
the layout the off-diag ids index. `matvec` posts the exchange, runs the
local block (B3 when banded, else B5) while it is in flight, waits, then
adds the off-diag rowsum (B5 on the ghost buffer): interior before halo.
`matmat` ships all k columns in one exchange and runs B6 on a banded local
block; its ELL local block and its off-diag block stay plain PyTorch
gathers (XLA in the JAX package, outside any Pallas kernel).

`dist_aij_from_scipy`'s setup is host numpy, as in the JAX package: every
rank runs the same vectorized plan on the global scipy matrix and keeps
its rows, so the statics (kd, ko, max_send, the band offsets) are global
and every rank's shapes agree. `dist_aij_from_rows` builds the same plan
from each rank's own rows alone (MatCreateMPIAIJWithArrays: the statics
reduced over the ranks, the ghost requests shipped to their owners), as
torch ops on the mesh's device after one upload of the rows' CSR, and
`dist_aij_to_dia` finds and scatters the bands there too; `fetch_rows`
brings a rank the rows it names from their owners: the streaming gamg
setup (solvers/amg.py) builds every level with them.
`exchange_triplets` routes COO triplets to their row owners
with all_to_all on the device (MatSetValues' stash-and-ship);
`DistAIJILU0PC` is block-Jacobi with a per-rank ILU(0) of the diag block
(PETSc's parallel default), applied with zero collectives.

Not ported: `dist_aij_df_from_scipy` and `dist_aij_matvec_df`, f32-pair
arithmetic the port drops (the H100 has f64): a float64 DistAIJ is
`solvers/refine.solve_refined`'s `matvec_df`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as dist

from saddle_point_petsc_tpu_torch.ops.cuda.dia import dia_spmv_2d
from saddle_point_petsc_tpu_torch.ops.cuda.dia_spmm import dia_spmm
from saddle_point_petsc_tpu_torch.ops.cuda.ell import ell_spmv
from saddle_point_petsc_tpu_torch.parallel.mesh import ProcessMesh, gather_rows
from saddle_point_petsc_tpu_torch.solvers import precond
from saddle_point_petsc_tpu_torch.utils import monitor


def make_mesh_1d(device=None) -> ProcessMesh:
    """The (1, world) mesh over the initialized process group, ranks in
    order along its one axis. `device=None` is the card (raises without
    one), as every library entry point; the CPU runs when asked for."""
    return ProcessMesh.create((1, dist.get_world_size()), device=device)


def _ell_rowsum_cols(cols_t, vals_t, X):
    """Y[i] = sum_s vals_t[s, i] * X[cols_t[s, i]] for X (n, k), slots in
    order (cols_t < 0 = padding): the plain gather of matmat's ELL
    blocks."""
    Y = X.new_zeros((cols_t.shape[1], X.shape[1]))
    for c, v in zip(cols_t, vals_t):
        Y = Y + torch.where(c >= 0, v, 0.0)[:, None] * X.index_select(0, c.clamp_min(0))
    return Y


def _host(t):
    """A tensor as a host numpy array."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class DistAIJ:
    """MATMPIAIJ-style matrix: this rank's block of rows over a (1, world)
    ProcessMesh (see the module docstring). Vectors are this rank's
    (n_loc_c,) rows of the global (n_pad_c,) vector; outputs its (n_loc,)
    rows."""

    diag_cols_t: torch.Tensor  # (kd, n_loc) int32 LOCAL column ids, -1 = padding
    diag_vals_t: torch.Tensor  # (kd, n_loc)
    off_cols_t: torch.Tensor  # (ko, n_loc) int32 ghost-buffer ids, -1 = padding
    off_vals_t: torch.Tensor  # (ko, n_loc)
    send_idx: torch.Tensor  # (world, max_send) int64: local ids shipped to each rank
    ghost_cols: np.ndarray  # (world * max_send,) int64: the global column of each ghost slot (host)
    shape: tuple  # true (m, n)
    n_pad: int
    mesh: ProcessMesh
    # the banded copy of the diag block: dia_data[k, i] is band
    # dia_offsets[k] of local row i (the union of every rank's bands)
    dia_data: Optional[torch.Tensor] = None  # (ndiag, n_loc)
    dia_offsets: tuple = ()
    # rectangular operators (AMG transfers): columns padded to n_pad_col;
    # None = square
    n_pad_col: Optional[int] = None
    # False when no rank has an off-diag entry: no exchange, no rowsum
    has_ghosts: bool = True
    # the exchange's (send, receive) buffers, per dtype and column shape
    _bufs: dict = dataclasses.field(init=False, default_factory=dict, repr=False, compare=False)
    # its vectors are this rank's rows (solvers/krylov.py)
    dist_leaves = ("rows",)

    @property
    def ndev(self):
        return self.mesh.size

    @property
    def n_loc(self):
        return self.n_pad // self.ndev

    @property
    def n_pad_c(self):
        return self.n_pad if self.n_pad_col is None else self.n_pad_col

    @property
    def n_loc_c(self):
        return self.n_pad_c // self.ndev

    @property
    def max_send(self):
        return self.send_idx.shape[-1]

    @property
    def nnz(self):
        """Stored ELL slots over all ranks, padding included (the JAX
        package's report convention); kd and ko are global, so no sum."""
        return (self.diag_cols_t.shape[0] + self.off_cols_t.shape[0]) * self.n_pad

    @property
    def ghost_count(self):
        """Ghost-buffer length per rank, the elements one matvec ships:
        independent of the global n."""
        return self.ndev * self.max_send

    def _exchange_start(self, x):
        """Post the ghost exchange of x, this rank's (n_loc_c,) or
        (n_loc_c, k) rows: the entries every rank needs are gathered into
        the send buffer and one all_to_all starts. None when no rank has an
        off-diag entry."""
        if not self.has_ghosts:
            return None
        key = (x.dtype, tuple(x.shape[1:]))
        if key not in self._bufs:
            shape = (self.ghost_count, *x.shape[1:])
            self._bufs[key] = (x.new_empty(shape), x.new_empty(shape))
        send, recv = self._bufs[key]
        torch.index_select(x, 0, self.send_idx.reshape(-1), out=send)
        return self.mesh.all_to_all(send, out=recv, async_op=True)

    def matvec(self, x):
        """y = A x: this rank's rows of x in, of y out."""
        x = x.contiguous()
        pending = self._exchange_start(x)
        if self.dia_data is not None:  # B3, launched before the wait
            y = dia_spmv_2d(self.dia_data, x, self.dia_offsets)
        else:
            y = ell_spmv(self.diag_cols_t, self.diag_vals_t, x)
        if pending is None:
            return y
        return y + ell_spmv(self.off_cols_t, self.off_vals_t, pending.wait())

    def __call__(self, x):
        return self.matvec(x)

    def matmat(self, X):
        """Y = A X for this rank's (n_loc_c, k) rows of X, any strides: one
        ghost exchange for all k columns; B6 on a banded local block."""
        pending = self._exchange_start(X)
        if self.dia_data is not None:
            Y = dia_spmm(self.dia_data, X, self.dia_offsets)
        else:
            Y = _ell_rowsum_cols(self.diag_cols_t, self.diag_vals_t, X)
        if pending is None:
            return Y
        return Y + _ell_rowsum_cols(self.off_cols_t, self.off_vals_t, pending.wait())

    def matmat_batch(self, X):
        """A on a (k, n_loc_c) batch of k vectors -> (k, n_loc): `matmat` on
        the transposed view, without a copy (KSPMatSolve's product)."""
        return self.matmat(X.T).T

    def diagonal(self):
        """diag(A), this rank's (n_loc,) rows: the diag-block entry whose
        local column is the local row. No communication."""
        if self.n_pad_col is not None:
            raise ValueError("diagonal(): square operators only")
        rloc = torch.arange(self.n_loc, device=self.diag_cols_t.device)
        return torch.where(self.diag_cols_t == rloc, self.diag_vals_t, 0.0).sum(0)

    def to_scipy_rows(self):
        """This rank's block of rows as a (n_loc, n_pad_c) scipy CSR with
        global columns: O(local nnz) host memory, no communication (the
        JAX package's `to_scipy_rows(s)` for s = this rank)."""
        rows, cols, vals = [], [], []
        dc, dv = _host(self.diag_cols_t).T, _host(self.diag_vals_t).T
        ri, ki = np.nonzero(dc >= 0)
        rows.append(ri)
        cols.append(dc[ri, ki].astype(np.int64) + self.mesh.rank * self.n_loc_c)
        vals.append(dv[ri, ki])
        oc, ov = _host(self.off_cols_t).T, _host(self.off_vals_t).T
        ri, ki = np.nonzero(oc >= 0)
        rows.append(ri)
        cols.append(self.ghost_cols[oc[ri, ki]])
        vals.append(ov[ri, ki])
        return sps.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.n_loc, self.n_pad_c),
        ).tocsr()

    def to_scipy(self):
        """The global (true-size) matrix on the host, on every rank.
        Collective; setup and output only (MatView, AMG setup)."""
        m, n = self.shape
        return gather_scipy_rows(self.to_scipy_rows(), self.mesh)[:m, :n]

    def diag_block_operator(self):
        """The block-diagonal part, the off-diag block dropped: the ranks
        decouple and its matvec calls no collective. The operator of
        per-rank block-Jacobi (PETSc's PCBJACOBI, one block per rank)."""
        empty = torch.full((1, self.n_loc), -1, dtype=torch.int32, device=self.off_cols_t.device)
        return dataclasses.replace(self, off_cols_t=empty, off_vals_t=self.off_vals_t.new_zeros((1, self.n_loc)),
                                   has_ghosts=False)


# ---------------------------------------------------------------------------
# Host setup: the plan of the JAX package, each rank keeping its rows
# ---------------------------------------------------------------------------


def gather_scipy_rows(part, mesh: ProcessMesh):
    """Every rank's scipy block of rows `part`, stacked in rank order, as
    one CSR on every rank (one all_gather_object; none in a world of
    one). Collective; setup and output only."""
    parts = [part]
    if mesh.size > 1:
        parts = [None] * mesh.size
        dist.all_gather_object(parts, part, group=mesh.group)
    return sps.vstack(parts).tocsr()


def _band_entries(dc, n_loc):
    """(rows, slots, band offsets) of the stored entries of diag-block ELL
    rows dc (rows, kd), the row counted within its rank's block."""
    r, k = np.nonzero(dc >= 0)
    return r, k, dc[r, k].astype(np.int64) - r % n_loc


def _check_bands(offs, n_pad, nnz_diag, max_diag_blowup, max_diags):
    if len(offs) > max_diags or len(offs) * n_pad > max_diag_blowup * max(nnz_diag, 1):
        raise ValueError(
            f"dist_aij diag bands: {len(offs)} bands x {n_pad} rows "
            f"exceeds {max_diag_blowup}x the diag nnz ({nnz_diag}); "
            "RCM-reorder first (local_rcm_permutation) or keep ELL"
        )


def _band_data(offs, r, k, off, dv, nrows):
    data = np.zeros((len(offs), nrows), dv.dtype)
    data[np.searchsorted(offs, off), r] = dv[r, k]
    return data


def _diag_band_layout(dc, dv, n_loc, n_pad, max_diag_blowup=4.0, max_diags=512):
    """(ndiag, n_pad) band array and static offsets of the global diag
    blocks dc, dv (n_pad, kd) (host numpy; raises ValueError on irregular
    band structures)."""
    r, k, off = _band_entries(dc, n_loc)
    offs = np.unique(off)
    _check_bands(offs, n_pad, len(r), max_diag_blowup, max_diags)
    return _band_data(offs, r, k, off, dv, n_pad), tuple(int(o) for o in offs)


def dist_aij_to_dia(A: DistAIJ, max_diag_blowup=4.0, max_diags=512) -> DistAIJ:
    """Attach the banded (DIA) copy of the diag blocks of a DistAIJ.

    Each rank finds its band set on its device from its diag-block ELL;
    the union over the ranks (one all_gather_object of the offsets) becomes
    the one offsets tuple of every rank, and each rank scatters its
    (ndiag, n_loc) bands on its device. Collective; setup. Raises
    ValueError (on every rank) when the bands would blow storage past
    `max_diag_blowup` x the diag-block nnz or `max_diags` bands; use
    `local_rcm_permutation` first for band-reducible irregular patterns.
    The ELL arrays are kept (diagonal(), ILU setup, to_scipy); only the
    products switch. The offsets are the only download (counted in
    `aij_build.d2h_bytes`); in a world of one they come down only when
    the band test passes.
    """
    if A.dia_data is not None:
        return A
    if A.n_pad_col is not None:
        raise ValueError("dist_aij_to_dia: square operators only")
    dc = A.diag_cols_t
    valid = dc >= 0
    row = torch.arange(A.n_loc, dtype=dc.dtype, device=dc.device).expand_as(dc)[valid]
    off = dc[valid].sub_(row)  # each stored entry's band
    mine = torch.unique(off)
    if A.ndev == 1:  # the union is this rank's set, whose size needs no download
        _check_bands(mine, A.n_pad, off.numel(), max_diag_blowup, max_diags)
        offs = _fetch(mine)
    else:
        parts = [None] * A.ndev
        dist.all_gather_object(parts, (_fetch(mine), off.numel()), group=A.mesh.group)
        offs = np.unique(np.concatenate([p[0] for p in parts]))
        _check_bands(offs, A.n_pad, sum(p[1] for p in parts), max_diag_blowup, max_diags)
        mine = _put(offs.astype(_np_dtype(dc.dtype)), dc.device)
    flat = torch.searchsorted(mine, off, out_int32=True).to(_index_dtype(len(offs) * A.n_loc))
    del off
    data = A.diag_vals_t.new_zeros((len(offs), A.n_loc))
    data.view(-1)[flat.mul_(A.n_loc).add_(row)] = A.diag_vals_t[valid]  # in place: data is fresh
    return dataclasses.replace(A, dia_data=data, dia_offsets=tuple(int(o) for o in offs))


def local_rcm_permutation(a, ndev):
    """Per-block symmetric RCM: a block-diagonal permutation that never
    moves a row across rank boundaries (row ownership is preserved), so
    each rank's diag block becomes banded for DIA storage.

    Returns `perm` with A_perm = A[perm][:, perm]; solve in permuted space
    and map back with x = x_perm[argsort(perm)] (PETSc's MatOrdering +
    KSPSolve-on-permuted-system pattern). Host scipy, as in the JAX
    package.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = a.tocsr()
    m = a.shape[0]
    n_loc = -(-m // ndev)
    perm = np.arange(m, dtype=np.int64)
    for s in range(ndev):
        lo, hi = s * n_loc, min((s + 1) * n_loc, m)
        blk = a[lo:hi, lo:hi].tocsr()
        p = reverse_cuthill_mckee(blk, symmetric_mode=True)
        perm[lo:hi] = lo + p.astype(np.int64)
    return perm


def _ell_pack(rows, cols, vals, nrows, k, dtype):
    """Pack row-major-sorted triplets into (nrows, k) ELL arrays (host)."""
    out_c = np.full((nrows, k), -1, np.int32)
    out_v = np.zeros((nrows, k), dtype)
    if len(rows):
        cnt = np.bincount(rows, minlength=nrows)
        firsts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        pos = np.arange(len(rows)) - firsts[rows]
        out_c[rows, pos] = cols
        out_v[rows, pos] = vals
    return out_c, out_v


def _np_dtype(dtype):
    """A numpy dtype from a numpy or torch dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def dist_aij_from_scipy(a, mesh: ProcessMesh, dtype=None, dia="auto") -> DistAIJ:
    """Partition a scipy sparse matrix into a DistAIJ (host setup).

    Every rank builds the diag/off-diag split and the ghost scatter plan of
    the whole matrix (the JAX package's vectorized numpy plan, no
    per-entry Python loop) and keeps its rows on the mesh's device. Square
    matrices get identity padding rows (harmless to Krylov with zero
    right-hand-side entries), rectangular ones (m != n, AMG transfers)
    empty ones, whose outputs are exact zeros.

    dtype: numpy or torch dtype of the values (default a's). dia: "auto"
    attaches the banded diag-block copy when it keeps DIA storage within
    2x the diag nnz; "off" keeps pure ELL; "force" attaches it with the
    permissive 4x/512-band thresholds and raises if even those fail.
    """
    a = a.tocsr()
    a.sum_duplicates()
    a.sort_indices()
    m, n = a.shape
    ndev, rank = mesh.size, mesh.rank
    n_loc = -(-m // ndev)
    n_pad = n_loc * ndev
    n_loc_c = -(-n // ndev)
    n_pad_c = n_loc_c * ndev
    square = m == n
    dtype = _np_dtype(dtype or a.dtype)

    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    vals = a.data.astype(dtype)
    if square and n_pad > m:
        pad_r = np.arange(m, n_pad, dtype=np.int64)
        rows = np.concatenate([rows, pad_r])
        cols = np.concatenate([cols, pad_r])
        vals = np.concatenate([vals, np.ones(n_pad - m, dtype)])

    owner_row = rows // n_loc
    owner_col = cols // n_loc_c
    isdiag = owner_col == owner_row

    # diag block: LOCAL column ids
    kd = 1
    dr, dcg, dvv = rows[isdiag], cols[isdiag], vals[isdiag]
    if len(dr):
        kd = max(1, int(np.bincount(dr, minlength=n_pad).max()))
    diag_cols, diag_vals = _ell_pack(dr, (dcg % n_loc_c).astype(np.int32), dvv, n_pad, kd, dtype)

    # ghost plan: unique (dest, col) needs, grouped by (src, dest)
    off = ~isdiag
    orow, ocol, oval = rows[off], cols[off], vals[off]
    if len(orow):
        comb = owner_row[off] * n_pad_c + ocol  # radix (dest, col)
        comb_pairs = np.unique(comb)  # sorted
        dest_p = comb_pairs // n_pad_c
        col_p = comb_pairs % n_pad_c
        src_p = col_p // n_loc_c
        # order within each (src, dest) group, columns ascending
        ordr = np.lexsort((col_p, dest_p, src_p))
        gkey = src_p[ordr] * ndev + dest_p[ordr]
        grp_cnt = np.bincount(gkey, minlength=ndev * ndev)
        max_send = max(1, int(grp_cnt.max()))
        grp_first = np.concatenate([[0], np.cumsum(grp_cnt)[:-1]])
        slot = np.arange(len(ordr)) - grp_first[gkey]
        ghost_of_pair = np.empty(len(ordr), np.int64)
        ghost_of_pair[ordr] = src_p[ordr] * max_send + slot
        send_idx = np.zeros((ndev, ndev, max_send), np.int32)
        send_idx[src_p[ordr], dest_p[ordr], slot] = (col_p[ordr] % n_loc_c).astype(np.int32)
        # each off-diag entry's ghost-buffer index
        gidx = ghost_of_pair[np.searchsorted(comb_pairs, comb)].astype(np.int32)
        ko = max(1, int(np.bincount(orow, minlength=n_pad).max()))
        off_cols, off_vals = _ell_pack(orow, gidx, oval, n_pad, ko, dtype)
    else:
        max_send = 1
        send_idx = np.zeros((ndev, ndev, 1), np.int32)
        off_cols = np.full((n_pad, 1), -1, np.int32)
        off_vals = np.zeros((n_pad, 1), dtype)

    dia_data, dia_offs = None, ()
    if square and dia in ("auto", "force"):
        try:
            dia_data, dia_offs = _diag_band_layout(
                diag_cols, diag_vals, n_loc, n_pad, max_diag_blowup=2.0 if dia == "auto" else 4.0
            )
        except ValueError:
            if dia == "force":
                raise

    lo, hi = rank * n_loc, (rank + 1) * n_loc

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)

    ghost_cols = (np.arange(ndev, dtype=np.int64)[:, None] * n_loc_c + send_idx[:, rank, :]).reshape(-1)
    return DistAIJ(
        put(diag_cols[lo:hi].T),
        put(diag_vals[lo:hi].T),
        put(off_cols[lo:hi].T),
        put(off_vals[lo:hi].T),
        put(send_idx[rank].astype(np.int64)),
        ghost_cols,
        (m, n),
        n_pad,
        mesh,
        dia_data=None if dia_data is None else put(dia_data[:, lo:hi]),
        dia_offsets=dia_offs,
        n_pad_col=None if square else n_pad_c,
        has_ghosts=bool(len(orow)),
    )


def _fetch(t):
    """A device tensor on the host, its bytes counted (`aij_build.d2h_bytes`)."""
    monitor.count("aij_build.d2h_bytes", t.nbytes)
    return _host(t)


def _put(arr, dev):
    """A host array on `dev`, its bytes counted (`aij_build.h2d_bytes`)."""
    monitor.count("aij_build.h2d_bytes", arr.nbytes)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _index_dtype(n):
    """int32 when indices below n fit it, else int64."""
    return torch.int32 if n < 2**31 else torch.int64


def _ell_pack_t(rows, cols, vals, cnt, k):
    """Slot-major (k, nrows) ELL arrays of row-major-sorted entries, on
    their device: an entry's slot is its index less its row's first index,
    as in `_ell_pack` (whose layout this is, transposed). cnt: the
    (nrows,) entries of each row; rows and cols int32."""
    nrows = cnt.numel()
    out_c = torch.full((k, nrows), -1, dtype=torch.int32, device=cnt.device)
    out_v = vals.new_zeros((k, nrows))
    if rows.numel():
        idx = _index_dtype(k * nrows)
        first = (torch.cumsum(cnt, 0) - cnt).to(idx)
        flat = torch.arange(rows.numel(), dtype=idx, device=cnt.device).sub_(first[rows]).mul_(nrows).add_(rows)
        out_c.view(-1)[flat] = cols  # in place: out_c and out_v are fresh
        out_v.view(-1)[flat] = vals
    return out_c, out_v


def _aij_from_rows_ell(a, m, n, mesh: ProcessMesh, dtype) -> DistAIJ:
    """`dist_aij_from_rows`' ELL build from this rank's canonical CSR a,
    after one upload of its three arrays: the plan runs on the mesh's
    device (see there). A function of its own so that its temporaries are
    freed before the bands are built: the build's transient device memory
    stays under the gamg set-up's peak."""
    ndev, rank, dev = mesh.size, mesh.rank, mesh.device
    n_loc, n_loc_c = a.shape[0], -(-n // ndev)
    lo, lo_c = rank * n_loc, rank * n_loc_c
    indptr, cols = _put(a.indptr, dev), _put(a.indices, dev)
    vals = _put(a.data.astype(dtype), dev)
    rows = torch.repeat_interleave(torch.arange(n_loc, dtype=torch.int32, device=dev), torch.diff(indptr),
                                   output_size=cols.numel())
    del indptr
    if m == n and m - lo < n_loc:  # the identity padding rows
        pad = torch.arange(max(m - lo, 0), n_loc, dtype=torch.int32, device=dev)
        rows, cols = torch.cat([rows, pad]), torch.cat([cols, (pad + lo).to(cols.dtype)])
        vals = torch.cat([vals, vals.new_ones(pad.numel())])

    isdiag = (cols >= lo_c) & (cols < lo_c + n_loc_c)
    isoff = ~isdiag
    orow, ocol, oval = rows[isoff], cols[isoff].long(), vals[isoff]
    if ocol.numel():  # else every entry is the diag block's: no copies
        rows, cols, vals = rows[isdiag], cols[isdiag], vals[isdiag]
    del isdiag, isoff
    cnt_d, cnt_o = torch.bincount(rows, minlength=n_loc), torch.bincount(orow, minlength=n_loc)
    need, inv = torch.unique(ocol, return_inverse=True)  # this rank's ghost columns, ascending
    src = need // n_loc_c
    grp = torch.bincount(src, minlength=ndev)
    stats = torch.stack([cnt_d.max(), cnt_o.max(), grp.max(), cnt_o.sum()])
    kd, ko, max_send, any_off = _fetch(mesh.all_reduce(stats, op=dist.ReduceOp.MAX)).tolist()
    diag_c, diag_v = _ell_pack_t(rows, (cols - lo_c).int(), vals, cnt_d, max(1, kd))
    del rows, cols, vals
    if any_off:
        ko, max_send = max(1, ko), max(1, max_send)
        ghost = src * max_send + torch.arange(need.numel(), device=dev) - (torch.cumsum(grp, 0) - grp)[src]
        off_c, off_v = _ell_pack_t(orow, ghost[inv].int(), oval, cnt_o, ko)
        req = torch.full((ndev * max_send,), -1, dtype=torch.int64, device=dev)
        req[ghost] = need  # in place: req is fresh
        asked = mesh.all_to_all(req).reshape(ndev, max_send)
        send_idx = torch.where(asked >= 0, asked - lo_c, 0)
        req = _fetch(req).reshape(ndev, max_send)
        # a padding slot holds the owner's first row, as dist_aij_from_scipy's
        ghost_cols = np.where(req >= 0, req, np.arange(ndev, dtype=np.int64)[:, None] * n_loc_c).reshape(-1)
    else:
        send_idx = torch.zeros((ndev, 1), dtype=torch.int64, device=dev)
        off_c = torch.full((1, n_loc), -1, dtype=torch.int32, device=dev)
        off_v = diag_v.new_zeros((1, n_loc))
        ghost_cols = np.arange(ndev, dtype=np.int64) * n_loc_c
    return DistAIJ(diag_c, diag_v, off_c, off_v, send_idx, ghost_cols, (m, n), n_loc * ndev, mesh,
                   n_pad_col=None if m == n else n_loc_c * ndev, has_ghosts=bool(any_off))


def dist_aij_from_rows(a_rows, n_cols, mesh: ProcessMesh, dtype=None, dia="auto", n_rows=None) -> DistAIJ:
    """This rank's DistAIJ from its own block of rows, no rank seeing
    another's (PETSc's MatCreateMPIAIJWithArrays).

    a_rows: this rank's (n_loc, >= n_cols) scipy block of the (n_rows,
    n_cols) matrix (n_rows None: square), rows block-partitioned as in
    dist_aij_from_scipy, columns global ids; square matrices get its
    identity padding rows. dtype and dia as in dist_aij_from_scipy.

    The host makes the block canonical (duplicates summed, columns sorted)
    and rounds its values to dtype, and the CSR's three arrays go to the
    mesh's device once; the row ids, the diag/off-diag split, the ELL
    packs, the ghost plan and the bands are built there. The statics and
    the plan equal dist_aij_from_scipy's on the matrix the blocks make up,
    field by field: kd, ko, max_send and whether any rank has an off-diag
    entry come from one all_reduce MAX, before anything is allocated; each
    rank asks the owners for its ghost columns, ascending within each
    owner, in one all_to_all of (world, max_send) ids (-1 past the
    request), and its send_idx row for a requester is that request in
    that order; the band test runs over every rank's bands
    (`dist_aij_to_dia`). The downloads are the statistics, the request
    (the host's `ghost_cols`) and the band offsets. Counted: the builds
    (`aij_build.count`) and the bytes up and down (`aij_build.h2d_bytes`,
    `aij_build.d2h_bytes`). Collective; setup.
    """
    m = n_cols if n_rows is None else n_rows
    n = n_cols
    ndev, rank = mesh.size, mesh.rank
    n_loc = -(-m // ndev)
    a = sps.csr_matrix(a_rows)
    if a.shape[0] != n_loc:
        raise ValueError(f"dist_aij_from_rows: rank {rank} holds {a.shape[0]} rows; {m} rows over {ndev} ranks "
                         f"give {n_loc} a rank")
    a.sum_duplicates()
    a.sort_indices()
    monitor.count("aij_build.count")
    A = _aij_from_rows_ell(a, m, n, mesh, _np_dtype(dtype or a.dtype))
    if m == n and dia in ("auto", "force"):
        try:
            A = dist_aij_to_dia(A, max_diag_blowup=2.0 if dia == "auto" else 4.0)
        except ValueError:
            if dia == "force":
                raise
    return A


def pad_vector(b, n_pad, mesh: ProcessMesh, dtype=None):
    """This rank's rows of b (a global (m,) or (m, k) numpy array or
    tensor) zero-padded to n_pad rows, on the mesh's device."""
    b = torch.as_tensor(b)
    n_loc = n_pad // mesh.size
    lo = mesh.rank * n_loc
    out = torch.zeros((n_loc, *b.shape[1:]), dtype=dtype or b.dtype, device=mesh.device)
    part = b[lo : min(lo + n_loc, b.shape[0])]
    out[: part.shape[0]] = part  # in place: out is the fresh buffer made above
    return out


def dist_aij_block_jacobi(A: DistAIJ, iters=8):
    """Per-rank block-Jacobi for a DistAIJ: fixed Chebyshev iterations with
    a Jacobi inner PC on the block-diagonal operator, which calls no
    collective; linear and symmetric for symmetric A, so valid under CG
    and MINRES. The bound comes from `estimate_lmax` over the ranks."""
    Ad = A.diag_block_operator()
    d = Ad.diagonal()
    inner = precond.JacobiPC(1.0 / torch.where(d == 0, 1.0, d))
    est = precond.estimate_lmax(Ad, M=inner, template=torch.zeros_like(d))
    return precond.chebyshev_pc(Ad, inner=inner, lmin=0.1 * 1.1 * est, lmax=1.1 * est, iters=iters)


# ---------------------------------------------------------------------------
# Distributed assembly: off-rank triplet exchange
# ---------------------------------------------------------------------------


def exchange_triplets(rows, cols, vals, mesh: ProcessMesh, n_loc: int, cap: int):
    """Route this rank's COO triplets to the ranks that own their rows
    (stash-and-ship, MatAssemblyBegin/End), on the device.

    rows/cols/vals: this rank's (E,) tensors; rows < 0 marks padding, which
    stays local. cap: the per-(src, dest) bucket capacity. Each bucket is
    one all_to_all. Returns (rows, cols, vals, overflow): this rank's
    (world * cap,) triplets, bucket by source rank (padding rows -1), and
    `overflow`, the number of ranks that had more than `cap` triplets for
    one destination (entries were dropped: re-run with a larger cap), from
    one all_reduce.
    """
    ndev, dev = mesh.size, rows.device
    dest = torch.where(rows >= 0, torch.div(rows, n_loc, rounding_mode="floor"), mesh.rank)
    order = torch.argsort(dest, stable=True)
    ds, rs, cs, vs = dest[order], rows[order], cols[order], vals[order]
    first = torch.searchsorted(ds, torch.arange(ndev, dtype=ds.dtype, device=dev))
    slot = torch.arange(ds.shape[0], device=dev) - first[ds]
    ok = slot < cap
    overflow = mesh.all_reduce((~ok & (rs >= 0)).any().to(torch.int32))
    ds, slot = ds[ok].long(), slot[ok]

    def bucket(t, fill):
        b = torch.full((ndev, cap), fill, dtype=t.dtype, device=dev)
        b[ds, slot] = t[ok]  # in place: b is the fresh bucket made above
        return mesh.all_to_all(b.reshape(-1))

    return bucket(rs, -1), bucket(cs, 0), bucket(vs, 0), overflow


def _triplet_cap(rows, n_loc, mesh: ProcessMesh):
    """The largest bucket any rank ships any other (rows < 0 stay local):
    exchange_triplets' exact capacity, from one all_reduce MAX."""
    dest = torch.where(rows >= 0, torch.div(rows, n_loc, rounding_mode="floor"), mesh.rank)
    biggest = torch.bincount(dest.long(), minlength=mesh.size).max().reshape(1)
    return max(1, int(mesh.all_reduce(biggest, op=dist.ReduceOp.MAX).item()))


def ship_triplets(rows, cols, vals, n_loc: int, mesh: ProcessMesh):
    """`exchange_triplets` of host numpy triplets at the exact capacity:
    the (rows, cols, vals) this rank received, on the host, padding
    dropped. Collective. The arrays' bytes to the device and back are
    counted (`triplets.h2d_bytes`, `triplets.d2h_bytes`)."""
    r, c, v = (torch.from_numpy(np.ascontiguousarray(t)).to(mesh.device) for t in (rows, cols, vals))
    monitor.count("triplets.h2d_bytes", sum(t.nbytes for t in (r, c, v)))
    r, c, v, _ = exchange_triplets(r, c, v, mesh, n_loc, _triplet_cap(r, n_loc, mesh))
    r, c, v = _host(r), _host(c), _host(v)
    monitor.count("triplets.d2h_bytes", r.nbytes + c.nbytes + v.nbytes)
    keep = r >= 0
    return r[keep], c[keep], v[keep]


def _route(dest, fields, mesh: ProcessMesh):
    """Ship variable-length host data: entry e of every field (numpy (E,)
    arrays) goes to rank dest[e]. The counts travel first (one
    all_to_all), then each field in equal-split buckets of the largest
    count any rank sends any other (one all_reduce MAX, one all_to_all a
    field), on the mesh's device. Returns (src, fields): the entries this
    rank received, by source rank and in each source's order, and each
    one's source rank. A world of one ships nothing."""
    if mesh.size == 1:
        return np.zeros(len(dest), np.int64), list(fields)
    ndev, dev = mesh.size, mesh.device
    cnt = np.bincount(dest, minlength=ndev)
    cnt_t = torch.from_numpy(cnt).to(dev)
    got = _host(mesh.all_to_all(cnt_t))
    cap = int(mesh.all_reduce(cnt_t.max().reshape(1), op=dist.ReduceOp.MAX).item())
    order = np.argsort(dest, kind="stable")
    ds = dest[order]
    slot = np.arange(len(ds)) - (np.cumsum(cnt) - cnt)[ds]
    keep = np.arange(cap) < got[:, None]
    out = []
    for f in fields:
        if cap == 0:
            out.append(f[:0])
            continue
        b = np.zeros((ndev, cap), f.dtype)
        b[ds, slot] = f[order]
        out.append(_host(mesh.all_to_all(torch.from_numpy(b.reshape(-1)).to(dev))).reshape(ndev, cap)[keep])
    return np.nonzero(keep)[0], out


def fetch_rows(a_rows, want, mesh: ProcessMesh):
    """The rows with the distinct global ids `want` of the matrix whose
    (n_loc, n) scipy block of rows each rank holds as a_rows (block
    partition, global column ids), from the ranks that own them: a CSR
    (len(want), n) in want's order. Collective: every rank calls it with
    its own want. Requests and rows travel as variable-length buckets,
    counts first (`_route`)."""
    a = sps.csr_matrix(a_rows)
    n_loc = a.shape[0]
    want = np.asarray(want, np.int64)
    asker, (ids,) = _route(want // n_loc, [want], mesh)
    sub = a[ids - mesh.rank * n_loc]
    cnt = np.diff(sub.indptr)
    _, (r, c, v) = _route(np.repeat(asker, cnt), [np.repeat(ids, cnt), sub.indices.astype(np.int64), sub.data],
                          mesh)
    order = np.argsort(want)
    return sps.csr_matrix((v, (order[np.searchsorted(want[order], r)], c)), shape=(len(want), a.shape[1]))


def dist_aij_from_coo(rows, cols, vals, n, mesh: ProcessMesh, cap=None, dtype=None) -> DistAIJ:
    """Distributed assembly: the device triplet exchange, then the host plan.

    rows/cols/vals: this rank's COO triplets (numpy or tensors; duplicates
    add, as ADD_VALUES; rows < 0 are padding). cap None takes the largest
    bucket of any rank exactly (one all_reduce of the counts); an explicit
    cap that is too small raises ValueError on every rank. The received
    triplets go to every rank (one all_gather) for the plan, which every
    rank builds, as PETSc builds its VecScatter plans on the host.
    """
    ndev = mesh.size
    n_loc = -(-n // ndev)
    rows, cols, vals = (torch.as_tensor(t).to(mesh.device) for t in (rows, cols, vals))
    if cap is None:
        cap = _triplet_cap(rows, n_loc, mesh)
    r, c, v, overflow = exchange_triplets(rows, cols, vals, mesh, n_loc, int(cap))
    if overflow.item():
        raise ValueError(f"exchange_triplets overflow: bucket capacity {cap} too small")
    r, c, v = (_host(gather_rows(t, mesh)) for t in (r, c, v))
    keep = r >= 0
    a = sps.coo_matrix((v[keep], (r[keep], c[keep])), shape=(n, n)).tocsr()
    return dist_aij_from_scipy(a, mesh, dtype=dtype)


# ---------------------------------------------------------------------------
# Per-rank ILU(0) local solves (PETSc's parallel default bjacobi + ILU)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistAIJILU0PC:
    """Block-Jacobi with a per-rank ILU(0) local solve for a DistAIJ: the
    factors of this rank's diag block in slot-major ELL, applied as
    `sweeps` Jacobi sweeps on each triangular factor (2 x sweeps launches
    of B5 an apply on a CUDA device), with zero collectives."""

    L_cols_t: torch.Tensor  # (kL, n_loc) int32, strictly lower
    L_vals_t: torch.Tensor
    U_cols_t: torch.Tensor  # (kU, n_loc) int32, strictly upper
    U_vals_t: torch.Tensor
    inv_diag: torch.Tensor  # (n_loc,)
    sweeps: int = 6

    def __call__(self, r):
        r = r.contiguous()
        # (I + L) y = r, unit diagonal: y <- r - L y
        y = r
        for _ in range(self.sweeps):
            y = r - ell_spmv(self.L_cols_t, self.L_vals_t, y)
        # (D + U) z = y: z <- D^-1 (y - U z)
        z = self.inv_diag * y
        for _ in range(self.sweeps):
            z = self.inv_diag * (y - ell_spmv(self.U_cols_t, self.U_vals_t, z))
        return z


def dist_aij_ilu0(A: DistAIJ, sweeps=6) -> DistAIJILU0PC:
    """Host setup: this rank factors its own diag block in f64
    (`precond.factor_values`, the native ILU(0)), after giving every row
    with a structurally missing or zero diagonal an identity entry; the
    factors go to A's device in its dtype as slot-major ELL. Raises
    ZeroDivisionError on a zero pivot (the JAX package falls back to its
    Python loop there)."""
    n_loc = A.n_loc
    dc, dv = _host(A.diag_cols_t).T, _host(A.diag_vals_t).T.astype(np.float64)
    ri, ki = np.nonzero(dc >= 0)
    a = sps.csr_matrix((dv[ri, ki], (ri, dc[ri, ki])), shape=(n_loc, n_loc))
    missing = np.nonzero(a.diagonal() == 0)[0]
    if len(missing):
        a = a + sps.csr_matrix((np.ones(len(missing)), (missing, missing)), shape=a.shape)
    a.sum_duplicates()
    a.sort_indices()
    data = precond.factor_values(a.indptr, a.indices, a.data, n_loc)
    f = sps.csr_matrix((data, a.indices, a.indptr), shape=a.shape)
    d = f.diagonal()
    dev, dtype = A.diag_vals_t.device, A.diag_vals_t.dtype
    np_dtype = _np_dtype(dtype)

    def pack(t):
        t = t.tocsr()
        k = max(1, int(np.diff(t.indptr).max(initial=0)))
        c, v = _ell_pack(np.repeat(np.arange(n_loc), np.diff(t.indptr)), t.indices, t.data, n_loc, k, np_dtype)
        return torch.from_numpy(np.ascontiguousarray(c.T)).to(dev), torch.from_numpy(np.ascontiguousarray(v.T)).to(dev)

    inv = torch.from_numpy(1.0 / np.where(d == 0, 1.0, d)).to(device=dev, dtype=dtype)
    return DistAIJILU0PC(*pack(sps.tril(f, k=-1)), *pack(sps.triu(f, k=1)), inv, sweeps)
