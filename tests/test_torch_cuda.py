"""Kernel B1 and the port's main path on a CUDA device.

These tests need a card and skip without one. They import neither jax nor
the JAX package, so a machine with CUDA torch and no jax runs them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`tests/conftest.py` imports jax). Tolerances: the kernel against its
plain version to 1e-5 * max|y| in f32 and 1e-12 * max|y| in f64 (the same
36 products summed in the same order; only FMA contraction differs); the
CLI on the card against the CLI on the CPU, both f64, to the same
iteration count +-2 and u to 1e-6 relative (the kernel's rounding differs
from the CPU's, and MINRES plateaus amplify it, see test_torch_saddle.py).
"""
import pytest
import torch

from saddle_point_petsc_tpu_torch import cli
from saddle_point_petsc_tpu_torch.models import poisson
from saddle_point_petsc_tpu_torch.ops.cuda import spmv
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
