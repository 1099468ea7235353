"""Port parity: saddle_point_petsc_tpu_torch.ops.stencil and kernel B1's
wrapper (ops/cuda/spmv.py) against the JAX package's ops.stencil and its
Pallas kernel, in float64 on the CPU.

Tolerances: assembly and layout results to 1e-13 * max|ref| (the same
adds in the same order, up to an ulp); matvecs to rtol = atol = 1e-12, as
the JAX package holds its own Pallas kernel (tests/test_pallas.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.ops import stencil as jst
from saddle_point_petsc_tpu.ops.pallas.spmv import (
    stencil_spmv_pallas,
    stencil_spmv_pallas_padded,
)
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.ops import stencil as tst
from saddle_point_petsc_tpu_torch.ops.cuda import spmv
from saddle_point_petsc_tpu_torch.utils import monitor

torch.set_num_threads(1)

REL = 1e-13


def _close(got, ref, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


@pytest.mark.parametrize("nex,ney", [(4, 3), (8, 8)])
def test_assemble_stencil_and_planes(nex, ney):
    ke = np.random.default_rng(nex).standard_normal((ney, nex, 8, 8))
    Wj = jst.assemble_stencil(jnp.asarray(ke))
    Wt = tst.assemble_stencil(torch.tensor(ke))
    _close(Wt, Wj)
    _close(tst.block_to_planes(Wt), jst.block_to_planes(Wj))
    _close(tst.planes_to_block(tst.block_to_planes(Wt)), Wj)


@pytest.mark.parametrize("ny,nx", [(5, 4), (9, 9)])
def test_zero_rows_columns(ny, nx):
    W = np.random.default_rng(3).standard_normal((ny, nx, 3, 3, 2, 2))
    mj = jst.boundary_mask(ny, nx)
    mt = tst.boundary_mask(ny, nx)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    _close(
        tst.stencil_zero_rows_columns(torch.tensor(W), mt, diag=2.5),
        jst.stencil_zero_rows_columns(jnp.asarray(W), mj, diag=2.5),
    )


@pytest.mark.parametrize("n", [13, 16])
@pytest.mark.parametrize("force", ["constant", "trig"])
def test_assemble_poisson_matches(n, force):
    pj = jpoisson.assemble_poisson(n - 1, n - 1, body_force=force)
    pt = tpoisson.assemble_poisson(n - 1, n - 1, body_force=force, device="cpu")
    _close(pt.A.planes, pj.A.planes)
    _close(pt.f, pj.f)
    _close(pt.coords, pj.coords)
    assert np.array_equal(pt.bc_mask.numpy(), np.asarray(pj.bc_mask))
    assert pt.A.nnz == pj.A.nnz and pt.A.shape == pj.A.shape
    _close(pt.A.diagonal(), pj.A.diagonal())
    _close(pt.A.diag_blocks(), pj.A.diag_blocks())


@pytest.mark.parametrize("n", [13, 16])
def test_plain_matvec_matches_jax_and_pallas(n):
    """The port's plain B1 against JAX planes_matvec_field and the JAX Pallas
    kernel in interpret mode (as tests/test_pallas.py runs it). Random
    planes: an assembled uniform-grid operator has planes[1] == planes[2]
    and would hide a swapped dof coupling."""
    rng = np.random.default_rng(n)
    planes = rng.standard_normal((4, 3, 3, n, n))
    x = rng.standard_normal((2, n, n))
    xp = rng.standard_normal((2, n + 2, n + 2))  # arbitrary halo ring
    y = tst.planes_matvec_field(torch.tensor(planes), torch.tensor(x)).numpy()
    yp = tst.planes_matvec_padded(torch.tensor(planes), torch.tensor(xp)).numpy()
    pj, xj, xpj = jnp.asarray(planes), jnp.asarray(x), jnp.asarray(xp)
    for ref in (
        jst.planes_matvec_field(pj, xj),
        stencil_spmv_pallas(pj, xj, bm=8, interpret=True),
    ):
        np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-12, atol=1e-12)
    for ref in (
        jst.planes_matvec_padded(pj, xpj),
        stencil_spmv_pallas_padded(pj, xpj, bm=4, interpret=True),
    ):
        np.testing.assert_allclose(yp, np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_operator_matvec_flat_and_field():
    n = 9
    planes = np.asarray(jpoisson.assemble_poisson(n - 1, n - 1, body_force="trig").A.planes)
    Aj, At = jst.StencilOperator(jnp.asarray(planes)), tst.StencilOperator(torch.tensor(planes))
    xf = np.random.default_rng(5).standard_normal(2 * n * n)
    np.testing.assert_allclose(
        At(torch.tensor(xf)).numpy(), np.asarray(Aj(jnp.asarray(xf))), rtol=1e-12, atol=1e-12
    )
    xT = tst.flat_to_field(torch.tensor(xf), n, n)
    _close(xT, jst.flat_to_field(jnp.asarray(xf), n, n))
    _close(tst.field_to_flat(xT), xf)
    _close(tst.field_to_nodes(xT), jst.field_to_nodes(jnp.asarray(xT.numpy())))
    _close(tst.nodes_to_field(tst.field_to_nodes(xT)), xT.numpy())


def test_stencil_to_coo_matches():
    W = np.asarray(jpoisson.assemble_poisson(3, 4).A.W)
    coo = jst.stencil_to_coo(jnp.asarray(W))
    rows, cols, vals = tst.stencil_to_coo(torch.tensor(W))
    assert np.array_equal(rows, np.asarray(coo.rows))
    assert np.array_equal(cols, np.asarray(coo.cols))
    np.testing.assert_array_equal(vals, np.asarray(coo.vals))


@pytest.mark.parametrize("padded", [False, True])
def test_wrapper_on_cpu_takes_plain_version(padded):
    rng = np.random.default_rng(11)
    planes = torch.tensor(rng.standard_normal((4, 3, 3, 6, 5)))
    shape = (2, 8, 7) if padded else (2, 6, 5)
    x = torch.tensor(rng.standard_normal(shape))
    monitor.reset_counters()
    if padded:
        y, ref = spmv.stencil_spmv_padded(planes, x), spmv.planes_matvec_padded(planes, x)
    else:
        y, ref = spmv.stencil_spmv(planes, x), spmv.planes_matvec_field(planes, x)
    assert torch.equal(y, ref)
    assert monitor.counters.get("B1.launches", 0) == 0


@pytest.mark.parametrize(
    "planes_shape,planes_dtype,x_shape,x_dtype,err",
    [
        ((4, 3, 3, 6, 5), torch.float64, (2, 6, 5), torch.float32, TypeError),
        ((4, 3, 3, 6, 5), torch.float16, (2, 6, 5), torch.float16, TypeError),
        ((4, 3, 3, 6, 5), torch.float64, (2, 5, 6), torch.float64, ValueError),
        ((4, 3, 3, 6, 5), torch.float64, (2, 8, 7), torch.float64, ValueError),
        ((2, 3, 3, 6, 5), torch.float64, (2, 6, 5), torch.float64, ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(planes_shape, planes_dtype, x_shape, x_dtype, err):
    planes = torch.zeros(planes_shape, dtype=planes_dtype)
    x = torch.zeros(x_shape, dtype=x_dtype)
    with pytest.raises(err):
        spmv.stencil_spmv(planes, x)


def test_wrapper_rejects_non_contiguous():
    planes = torch.zeros((4, 3, 3, 6, 5), dtype=torch.float64)
    x = torch.zeros((2, 5, 6), dtype=torch.float64).transpose(1, 2)
    with pytest.raises(ValueError):
        spmv.stencil_spmv(planes, x)

