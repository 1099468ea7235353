"""Port parity: saddle_point_petsc_tpu_torch.ops.sparse and the wrappers of
kernels B3/B3' and B4 (ops/cuda/dia.py, ops/cuda/bdia.py) against the JAX
package's ops.sparse and its Pallas kernels, in float64 on the CPU.

Tolerances: index arrays, offsets and active triples exactly; values and
matvecs to 1e-12 * max|ref| (the same products summed in the same order,
up to an ulp; the JAX Pallas block-DIA kernel sums in another order).
The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from saddle_point_petsc_tpu.models import fem as jfem
from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.ops import sparse as jsp
from saddle_point_petsc_tpu.ops.pallas.spmv import (
    bdia_spmv_pallas_2d,
    dia_spmv_pallas,
    dia_spmv_pallas_2d,
)
from saddle_point_petsc_tpu.ops.stencil import stencil_to_coo as jstencil_to_coo
from saddle_point_petsc_tpu_torch.models import fem as tfem
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.ops.cuda import bdia, dia
from saddle_point_petsc_tpu_torch.utils import monitor

torch.set_num_threads(1)

REL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * max(np.max(np.abs(ref), initial=0.0), 1e-300)


def _equal(got, ref):
    assert np.array_equal(_np(got), _np(ref))


def _random_coo(seed, m=23, n=23, nnz=150, npad=12):
    """Triplets with many duplicates and padding rows (row = col = -1)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    pad = rng.choice(nnz, npad, replace=False)
    rows[pad], cols[pad] = -1, -1
    return rows, cols, vals, (m, n)


def _both_coo(seed, **kw):
    rows, cols, vals, shape = _random_coo(seed, **kw)
    j = jsp.COO(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32), jnp.asarray(vals), shape)
    t = tsp.COO(torch.tensor(rows), torch.tensor(cols), torch.tensor(vals), shape)
    return j, t


@functools.lru_cache(maxsize=None)
def _jax_poisson_csr(n):
    return jpoisson.assemble_poisson_csr(n - 1, n - 1)[0]


def _poisson_csr(n):
    """The JAX package's assembled CSR at n x n nodes, and the port's copy."""
    csr_j = _jax_poisson_csr(n)
    csr_t = tsp.csr_from_numpy(np.asarray(csr_j.indptr), np.asarray(csr_j.cols),
                               np.asarray(csr_j.vals), csr_j.shape, device="cpu")
    return csr_j, csr_t


def _laplacian_2d(n1):
    ix = sps.identity(n1)
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n1, n1))
    return (sps.kron(ix, t) + sps.kron(t, ix)).tocsr()


@pytest.mark.parametrize("seed", [0, 1])
def test_coo_sum_duplicates_and_coo_to_csr(seed):
    cj, ct = _both_coo(seed)
    dj, dt = jsp.coo_sum_duplicates(cj), tsp.coo_sum_duplicates(ct)
    _equal(dt.rows, dj.rows)
    _equal(dt.cols, dj.cols)
    _close(dt.vals, dj.vals)
    rj, rt = jsp.coo_to_csr(cj), tsp.coo_to_csr(ct)
    _equal(rt.indptr, rj.indptr)
    _equal(rt.cols, rj.cols)  # padding (-1) at the tail, as in JAX
    _close(rt.vals, rj.vals)
    kj, kt = jsp.csr_compact(rj), tsp.csr_compact(rt)
    assert kt.nnz == kj.nnz
    _equal(kt.cols, kj.cols)
    _close(kt.todense(), kj.todense())
    _close(ct.todense(), cj.todense())


@pytest.mark.parametrize("nex,ney", [(3, 4), (8, 8)])
def test_assemble_poisson_csr_matches(nex, ney):
    csr_j, f_j, m_j, c_j = jpoisson.assemble_poisson_csr(nex, ney)
    csr_t, f_t, m_t, c_t = tpoisson.assemble_poisson_csr(nex, ney, device="cpu")
    _equal(csr_t.indptr, csr_j.indptr)
    _equal(csr_t.cols, csr_j.cols)
    _close(csr_t.vals, csr_j.vals, rel=1e-13)
    _close(f_t, f_j, rel=1e-13)
    _equal(m_t, m_j)
    _close(c_t, c_j)
    _equal(tfem.element_eqnums(nex, ney), jfem.element_eqnums(nex, ney))
    _equal(tfem.element_eqnums(nex, ney, nx_nodes=nex + 3), jfem.element_eqnums(nex, ney, nx_nodes=nex + 3))


def test_coo_zero_rows_columns_matches():
    cj, ct = _both_coo(2)
    mask = np.random.default_rng(3).random(23) < 0.3
    zj = jsp.coo_zero_rows_columns(cj, jnp.asarray(mask), diag=2.5)
    zt = tsp.coo_zero_rows_columns(ct, torch.tensor(mask), diag=2.5)
    _equal(zt.rows, zj.rows)
    _equal(zt.cols, zj.cols)
    _close(zt.vals, zj.vals)


def _random_square(seed, n=40, density=0.15):
    a = sps.random(n, n, density=density, random_state=seed, format="csr") + sps.eye(n)
    return a.tocsr()


@pytest.mark.parametrize("case", ["poisson9", "poisson17", "random"])
def test_csr_to_dia_offsets_exact(case):
    if case == "random":
        a = _random_square(5)
        csr_j = jsp.scipy_to_csr(a)
        csr_t = tsp.scipy_to_csr(a, device="cpu")
    else:
        csr_j, csr_t = _poisson_csr(int(case[7:]))
    dj, pj = jsp.csr_to_dia(csr_j)
    dt, pt = tsp.csr_to_dia(csr_t)
    assert pj is None and pt is None
    assert dt.offsets == dj.offsets  # same offsets in the same order
    assert dt.shape == tuple(dj.shape) and dt.nnz == dj.nnz  # nnz counts padding
    _close(dt.data, dj.data)
    _close(tsp.dia_to_scipy(dt).toarray(), csr_j.todense())


def test_csr_to_dia_rcm_matches():
    a = _random_square(2, n=60, density=0.06)
    a = (a + a.T).tocsr()
    dj, pj = jsp.csr_to_dia(jsp.scipy_to_csr(a), rcm_reorder=True)
    dt, pt = tsp.csr_to_dia(tsp.scipy_to_csr(a, device="cpu"), rcm_reorder=True)
    _equal(pt, pj)
    assert dt.offsets == dj.offsets
    _close(dt.data, dj.data)


@pytest.mark.parametrize("n", [9, 17])
def test_bsr_to_bdia_offsets_and_active_exact(n):
    csr_j, csr_t = _poisson_csr(n)
    bsr_j, bsr_t = jsp.csr_to_bsr(csr_j, 2), tsp.csr_to_bsr(csr_t, 2)
    _equal(bsr_t.indptr, bsr_j.indptr)
    _equal(bsr_t.cols, bsr_j.cols)
    _close(bsr_t.vals, bsr_j.vals)
    bj, bt = jsp.bsr_to_bdia(bsr_j), tsp.bsr_to_bdia(bsr_t)
    assert bt.offsets == bj.offsets
    assert bt.active == bj.active
    assert bt.nnz == bj.nnz and bt.block == bj.block
    _close(bt.data, bj.data)
    _close(bt.todense(), bj.todense())
    _close(tsp.to_scipy(bt).toarray(), csr_j.todense())


def _formats(n=9):
    """(name, jax container, port container) for every format over the
    same assembled n x n-node matrix (ELL from a random matrix too)."""
    csr_j, csr_t = _poisson_csr(n)
    a = _random_square(7, n=csr_j.shape[0], density=0.02)
    rows, cols = a.nonzero()
    vals = np.asarray(a[rows, cols]).reshape(-1)
    coo_j = jsp.COO(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32), jnp.asarray(vals), a.shape)
    coo_t = tsp.COO(torch.tensor(rows), torch.tensor(cols), torch.tensor(vals), a.shape)
    out = [("coo", coo_j, coo_t), ("csr", csr_j, csr_t)]
    out.append(("ell", jsp.csr_to_ell(jsp.scipy_to_csr(a)), tsp.csr_to_ell(tsp.scipy_to_csr(a, device="cpu"))))
    out.append(("bsr", jsp.csr_to_bsr(csr_j, 2), tsp.csr_to_bsr(csr_t, 2)))
    out.append(("dia", jsp.csr_to_dia(csr_j)[0], tsp.csr_to_dia(csr_t)[0]))
    out.append(("bdia", jsp.bsr_to_bdia(jsp.csr_to_bsr(csr_j, 2)),
                tsp.bsr_to_bdia(tsp.csr_to_bsr(csr_t, 2))))
    return out


_MATVEC_J = {"coo": jsp.coo_matvec, "csr": jsp.csr_matvec, "ell": jsp.ell_matvec,
             "bsr": jsp.bsr_matvec, "dia": jsp.dia_matvec, "bdia": jsp.bdia_matvec}
_MATVEC_T = {"coo": tsp.coo_matvec, "csr": tsp.csr_matvec, "ell": tsp.ell_matvec,
             "bsr": tsp.bsr_matvec, "dia": tsp.dia_matvec, "bdia": tsp.bdia_matvec}
_MATMAT_J = {"coo": jsp.coo_matmat, "csr": jsp.csr_matmat, "ell": jsp.ell_matmat,
             "bsr": jsp.bsr_matmat, "dia": jsp.dia_matmat, "bdia": jsp.bdia_matmat}
_MATMAT_T = {"coo": tsp.coo_matmat, "csr": tsp.csr_matmat, "ell": tsp.ell_matmat,
             "bsr": tsp.bsr_matmat, "dia": tsp.dia_matmat, "bdia": tsp.bdia_matmat}


@pytest.mark.parametrize("fmt", ["coo", "csr", "ell", "bsr", "dia", "bdia"])
def test_matvec_and_matmat_match(fmt):
    (_, Aj, At), = [f for f in _formats() if f[0] == fmt]
    rng = np.random.default_rng(11)
    n = At.shape[0]
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    _close(_MATVEC_T[fmt](At, torch.tensor(x)), _MATVEC_J[fmt](Aj, jnp.asarray(x)))
    _close(_MATMAT_T[fmt](At, torch.tensor(X)), _MATMAT_J[fmt](Aj, jnp.asarray(X)))
    _close(At.todense(), Aj.todense())
    if fmt != "coo":
        _close(At(torch.tensor(x)), Aj(jnp.asarray(x)))


def test_diagonal_extractors_match():
    csr_j, csr_t = _poisson_csr(9)
    _close(tsp.csr_extract_diagonal(csr_t), jsp.csr_extract_diagonal(csr_j))
    bj, bt = jsp.csr_to_bsr(csr_j, 2), tsp.csr_to_bsr(csr_t, 2)
    _close(tsp.bsr_extract_diag_blocks(bt), jsp.bsr_extract_diag_blocks(bj))
    _close(tsp.csr_to_dia(csr_t)[0].diagonal(), jsp.csr_to_dia(csr_j)[0].diagonal())
    _close(tsp.bsr_to_bdia(bt).diagonal(), jsp.bsr_to_bdia(bj).diagonal())
    _close(tsp.csr_extract_diagonal(csr_t), tsp.bsr_to_bdia(bt).diagonal())


def test_from_numpy_constructors():
    csr_j, _ = _poisson_csr(9)
    dj = jsp.csr_to_dia(csr_j)[0]
    bj = jsp.bsr_to_bdia(jsp.csr_to_bsr(csr_j, 2))
    dt = tsp.dia_from_numpy(np.asarray(dj.data), dj.offsets, dj.shape, device="cpu")
    bt = tsp.bdia_from_numpy(np.asarray(bj.data), bj.offsets, bj.shape, bj.block, bj.active,
                             device="cpu")
    x = np.random.default_rng(1).standard_normal(dj.shape[0])
    _close(dt(torch.tensor(x)), dj(jnp.asarray(x)))
    _close(bt(torch.tensor(x)), bj(jnp.asarray(x)))
    assert bt.active == bj.active and dt.offsets == dj.offsets


# -- plain versions of kernels B3/B3' and B4 against the Pallas kernels ------


def _dia_cases():
    """The cases of tests/test_pallas.py, in float64."""
    coo = jstencil_to_coo(jpoisson.assemble_poisson(7, 7).A.W)
    csr = jsp.csr_compact(jsp.coo_to_csr(coo))
    stencil = jsp.csr_to_dia(csr)[0]
    lap = jsp.csr_to_dia(jsp.scipy_to_csr(_laplacian_2d(37)))[0]  # offsets +-37: lane-crossing
    rng = np.random.default_rng(4)
    offs = (-300, -17, -1, 0, 3, 129, 255)
    rand = jsp.DIA(jnp.asarray(rng.standard_normal((len(offs), 1000))), offs, (1000, 1000))
    return {"stencil8": stencil, "laplace37": lap, "random_offsets": rand}


@pytest.mark.parametrize("case", ["stencil8", "laplace37", "random_offsets"])
def test_plain_dia_matches_pallas(case):
    d = _dia_cases()[case]
    x = np.random.default_rng(5).standard_normal(d.shape[0])
    data_t, x_t = torch.tensor(np.asarray(d.data)), torch.tensor(x)
    y2 = dia.dia_spmv_2d(data_t, x_t, d.offsets)
    y1 = dia.dia_spmv(data_t, x_t, d.offsets)
    _close(y2, dia_spmv_pallas_2d(d.data, jnp.asarray(x), d.offsets, interpret=True))
    _close(y1, dia_spmv_pallas(d.data, jnp.asarray(x), d.offsets, bn=32, interpret=True))
    _close(y2, jsp.dia_matvec(d, jnp.asarray(x)))


@pytest.mark.parametrize("case", ["laplace20", "poisson9"])
def test_plain_bdia_matches_pallas(case):
    """The 2x2 block case of tests/test_pallas.py (a 5-point Laplacian on
    20 x 20 points), float64, and the assembled 9 x 9-node operator."""
    if case == "laplace20":
        csr = jsp.scipy_to_csr(_laplacian_2d(20))
    else:
        csr = _jax_poisson_csr(9)
    b = jsp.bsr_to_bdia(jsp.csr_to_bsr(csr, block=2))
    x = np.random.default_rng(6).standard_normal(csr.shape[0])
    xb = np.ascontiguousarray(x.reshape(-1, 2).T)
    y = bdia.bdia_spmv_2d(torch.tensor(np.asarray(b.data)), torch.tensor(xb), b.offsets, b.active)
    _close(y, bdia_spmv_pallas_2d(b.data, jnp.asarray(xb), b.offsets, b.active, interpret=True))
    _close(y, jsp.bdia_matvec_dofmajor(b, jnp.asarray(xb)))


def test_plain_bdia_random_active_matches_xla():
    rng = np.random.default_rng(9)
    b, mb, offs = 3, 53, (-7, -1, 0, 2, 30)
    triples = [(k, c, d) for k in range(len(offs)) for c in range(b) for d in range(b)]
    active = tuple(t for t in triples if rng.random() < 0.5)
    data = rng.standard_normal((len(offs), b, b, mb))
    xb = rng.standard_normal((b, mb))
    Bj = jsp.BDIA(jnp.asarray(data), offs, (b * mb, b * mb), b, active)
    y = bdia.bdia_spmv_2d(torch.tensor(data), torch.tensor(xb), offs, active)
    _close(y, jsp.bdia_matvec_dofmajor(Bj, jnp.asarray(xb)))
    _close(y, bdia_spmv_pallas_2d(Bj.data, jnp.asarray(xb), offs, active, interpret=True))


# -- the wrappers on the CPU ---------------------------------------------------


def test_wrappers_on_cpu_take_plain_versions():
    rng = np.random.default_rng(3)
    offs = (-2, 0, 5)
    data, x = torch.tensor(rng.standard_normal((3, 11))), torch.tensor(rng.standard_normal(11))
    bdata, xb = torch.tensor(rng.standard_normal((3, 2, 2, 11))), torch.tensor(rng.standard_normal((2, 11)))
    active = ((0, 0, 1), (2, 1, 0), (1, 1, 1))
    monitor.reset_counters()
    assert torch.equal(dia.dia_spmv_2d(data, x, offs), dia.dia_spmv_plain(data, x, offs))
    assert torch.equal(dia.dia_spmv(data, x, offs), dia.dia_spmv_plain(data, x, offs))
    assert torch.equal(bdia.bdia_spmv_2d(bdata, xb, offs, active), bdia.bdia_spmv_plain(bdata, xb, offs, active))
    assert monitor.counters.get("B3.launches", 0) == 0 and monitor.counters.get("B4.launches", 0) == 0


@pytest.mark.parametrize(
    "data_shape,x_shape,dtypes,offsets,err",
    [
        ((3, 11), (11,), (torch.float64, torch.float32), (-2, 0, 5), TypeError),
        ((3, 11), (11,), (torch.float16, torch.float16), (-2, 0, 5), TypeError),
        ((3, 11), (12,), (torch.float64, torch.float64), (-2, 0, 5), ValueError),
        ((2, 11), (11,), (torch.float64, torch.float64), (-2, 0, 5), ValueError),
        ((3, 11), (11,), (torch.float64, torch.float64), (-2, 0.0, 5), ValueError),
        ((3, 0), (0,), (torch.float64, torch.float64), (-2, 0, 5), ValueError),
    ],
)
def test_dia_wrapper_rejects_bad_inputs(data_shape, x_shape, dtypes, offsets, err):
    with pytest.raises(err):
        dia.dia_spmv_2d(torch.zeros(data_shape, dtype=dtypes[0]), torch.zeros(x_shape, dtype=dtypes[1]), offsets)


def test_bdia_wrapper_rejects_non_contiguous_and_bad_shapes():
    data = torch.zeros((2, 2, 2, 7), dtype=torch.float64)
    active = ((0, 0, 0), (1, 1, 1))
    xb = torch.zeros((7, 2), dtype=torch.float64).T  # a dof-major view, not contiguous
    with pytest.raises(ValueError):
        bdia.bdia_spmv_2d(data, xb, (0, 1), active)
    with pytest.raises(ValueError):
        bdia.bdia_spmv_2d(data, torch.zeros((2, 6), dtype=torch.float64), (0, 1), active)
    with pytest.raises(ValueError):
        bdia.triples_table((0, 1), ((0, 2, 0),), 2)


def test_bdia_matvec_copies_flat_vector_to_dof_major():
    """The flat matvec makes its dof-major copy explicitly; the result
    matches the dense product."""
    _, csr_t = _poisson_csr(9)
    B = tsp.bsr_to_bdia(tsp.csr_to_bsr(csr_t, 2))
    x = torch.tensor(np.random.default_rng(2).standard_normal(B.shape[0]))
    _close(tsp.bdia_matvec(B, x), B.todense() @ x)


def test_triples_table_groups_by_row_in_active_order():
    active = ((0, 1, 0), (1, 0, 1), (2, 1, 1), (0, 0, 0))
    offsets = (-3, 0, 4)
    t = bdia.triples_table(offsets, active, 2)
    # starts | off | plane | dof, c = 0 first: (1,0,1), (0,0,0); then c = 1: (0,1,0), (2,1,1)
    assert t == [0, 2, 4] + [0, -3, -3, 4] + [1 * 4 + 1, 0, 2, 2 * 4 + 3] + [1, 0, 0, 1]
