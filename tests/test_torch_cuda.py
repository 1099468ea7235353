"""Kernels B1, B3/B3' and B4 and the port's routes on a CUDA device.

These tests need a card and skip without one. They import neither jax nor
the JAX package, so a machine with CUDA torch and no jax runs them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`tests/conftest.py` imports jax). Tolerances: the kernel against its
plain version to 1e-5 * max|y| in f32 and 1e-12 * max|y| in f64 (the same
36 products summed in the same order; only FMA contraction differs); the
CLI on the card against the CLI on the CPU, both f64, to the same
iteration count +-2 and u to 1e-6 relative (the kernel's rounding differs
from the CPU's, and MINRES plateaus amplify it, see test_torch_saddle.py).
B3 and B4 round every product and sum as their plain versions do, in the
same order, and are held to the same bounds as B1 (they give equal bits).
"""
import random

import pytest
import torch

from saddle_point_petsc_tpu_torch import cli
from saddle_point_petsc_tpu_torch.models import poisson
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.cuda import bdia, dia, spmv
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_matches_plain(dev, dtype, tol):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for nx, ny in ((1, 1), (4, 4), (7, 5), (33, 17), (130, 67)):
        planes = torch.randn((4, 3, 3, ny, nx), generator=gen, dtype=dtype, device=dev)
        x = torch.randn((2, ny, nx), generator=gen, dtype=dtype, device=dev)
        xp = torch.randn((2, ny + 2, nx + 2), generator=gen, dtype=dtype, device=dev)
        spmv.reset_launches()
        y, yp = spmv.stencil_spmv(planes, x), spmv.stencil_spmv_padded(planes, xp)
        assert spmv.launches == 2
        torch.cuda.synchronize()
        for got, ref in (
            (y, spmv.planes_matvec_field(planes, x)),
            (yp, spmv.planes_matvec_padded(planes, xp)),
        ):
            assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_wrapper_rejects_mixed_devices(dev):
    planes = torch.zeros((4, 3, 3, 5, 6), dtype=torch.float64)
    with pytest.raises(ValueError):
        spmv.stencil_spmv(planes, torch.zeros((2, 5, 6), dtype=torch.float64, device=dev))


def test_operator_on_card_launches_kernel(dev):
    A = poisson.assemble_poisson(12, 9, dtype=torch.float64, device=dev, body_force="trig").A
    x = torch.randn((2, 10, 13), dtype=torch.float64, device=dev)
    spmv.reset_launches()
    y = A(x)
    assert spmv.launches == 1
    ref = spmv.planes_matvec_field(A.planes, x)
    assert (y - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


def test_cli_on_card_matches_cpu(dev):
    argv = ["-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "17",
            "-da_grid_y", "17", "-dtype", "f64", "-ksp_rtol", "1e-8", "-no_vtk"]
    spmv.reset_launches()
    card = cli.run(argv + ["-device", "cuda"])
    launches = spmv.launches
    host = cli.run(argv + ["-device", "cpu"])
    assert card.rc == host.rc == 0
    assert launches >= card.result.iterations
    assert abs(card.result.iterations - host.result.iterations) <= 2
    u_card, u_host = card.result.x[0].cpu(), host.result.x[0]
    assert (u_card - u_host).norm() <= 1e-6 * u_host.norm()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_dia_kernel_matches_plain(dev, dtype, tol):
    """B3 through both entry names: lane-crossing offsets, rows not a
    multiple of 32, an offset beyond the rows, and no bands at all."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for n, offs in ((1, (0,)), (37, (-37, -1, 0, 1, 37)), (1000, (-300, -17, -1, 0, 3, 129, 255)),
                    (50, (-80, 2, 60)), (9, ())):
        data = torch.randn((len(offs), n), generator=gen, dtype=dtype, device=dev)
        x = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
        dia.reset_launches()
        y2, y1 = dia.dia_spmv_2d(data, x, offs), dia.dia_spmv(data, x, offs)
        assert dia.launches == 2
        ref = dia.dia_spmv_plain(data, x, offs)
        torch.cuda.synchronize()
        for got in (y2, y1):
            assert (got - ref).abs().max().item() <= tol * max(ref.abs().max().item(), 1e-300)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_bdia_kernel_matches_plain(dev, dtype, tol):
    """B4 for b = 1, 2, 3 with random active triples."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rnd = random.Random(1)
    offs = (-40, -3, 0, 1, 7, 300)
    for b in (1, 2, 3):
        for mb in (5, 777):
            triples = [(k, c, d) for k in range(len(offs)) for c in range(b) for d in range(b)]
            active = tuple(t for t in triples if rnd.random() < 0.6)
            data = torch.randn((len(offs), b, b, mb), generator=gen, dtype=dtype, device=dev)
            xb = torch.randn((b, mb), generator=gen, dtype=dtype, device=dev)
            bdia.reset_launches()
            y = bdia.bdia_spmv_2d(data, xb, offs, active)
            assert bdia.launches == 1
            ref = bdia.bdia_spmv_plain(data, xb, offs, active)
            torch.cuda.synchronize()
            assert (y - ref).abs().max().item() <= tol * max(ref.abs().max().item(), 1e-300)


def test_sparse_operators_on_card_launch_kernels(dev):
    """A CUDA DIA operator launches B3 and a CUDA block-DIA operator B4,
    once per matvec, and both match the CSR matvec."""
    csr, _, _, _ = poisson.assemble_poisson_csr(12, 9, device=dev)
    A, _ = sparse.csr_to_dia(csr)
    B = sparse.bsr_to_bdia(sparse.csr_to_bsr(csr, 2))
    x = torch.randn((csr.shape[0],), dtype=torch.float64, device=dev)
    dia.reset_launches()
    bdia.reset_launches()
    ya, yb, ref = A(x), B(x), csr(x)
    assert dia.launches == 1 and bdia.launches == 1
    for got in (ya, yb):
        assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


def test_cli_gamg_on_card_matches_cpu(dev):
    argv = ["-mat_type", "dia", "-ksp_type", "cg", "-pc_type", "gamg", "-da_grid_x", "33",
            "-da_grid_y", "33", "-dtype", "f64", "-ksp_rtol", "1e-8", "-no_vtk"]
    dia.reset_launches()
    card = cli.run(argv + ["-device", "cuda"])
    launches = dia.launches
    host = cli.run(argv + ["-device", "cpu"])
    assert card.rc == host.rc == 0
    assert launches >= card.result.iterations
    assert abs(card.result.iterations - host.result.iterations) <= 1
    x_card, x_host = card.result.x.cpu(), host.result.x
    assert (x_card - x_host).norm() <= 1e-6 * x_host.norm()
