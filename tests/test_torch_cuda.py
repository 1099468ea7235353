"""Kernels B1-B6 and the port's routes on a CUDA device.

These tests need a card and skip without one. They import neither jax nor
the JAX package, so a machine with CUDA torch and no jax runs them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`tests/conftest.py` imports jax). Tolerances: the kernel against its
plain version to 1e-5 * max|y| in f32 and 1e-12 * max|y| in f64 (the same
36 products summed in the same order; only FMA contraction differs); the
CLI on the card against the CLI on the CPU, both f64, to the same
iteration count +-2 and u to 1e-6 relative (the kernel's rounding differs
from the CPU's, and MINRES plateaus amplify it, see test_torch_saddle.py).
B3, B4, B5 and B6 round every product and sum as their plain versions
do, in the same order, and B2 sums as B1 does; all are held to the same
bounds as B1. KSPMatSolve on the card against the CPU: iterations +-1
(batched dot products reduce in another order on the card), x to 1e-9.
Multigrid, SOR, ILU(0) and one refinement cycle on the card against the
same call on CPU tensors: 1e-12 * max|y| in f64, 1e-5 * max|y| in f32 (the
V-cycle and the refinement's inner solve run in f32); the MG coarsest
inverse formed on the card against numpy's, 1e-12 of its largest entry
in f64. Kernel FE (the -dist
assembly) against its plain version, and the -dist assembly against the
serial one: in f64 planes to 1e-12, loads and constraint rows to 1e-12 of
their largest entry; 4 ulp of the largest entry in f32 (the batched
products sum in another order). Kernel RN (the normal draws) against its
CPU twin: the Philox words bit-equal, the normals within 4 ulp (the card's
log, sin and cos against numpy's), and estimate_lmax on the card against
the CPU within 1e-13 relative.
"""
import random

import pytest
import torch

from saddle_point_petsc_tpu_torch import cli
from saddle_point_petsc_tpu_torch.models import poisson
from saddle_point_petsc_tpu_torch.ops import sparse
from saddle_point_petsc_tpu_torch.ops.cuda import bdia, dia, dia_spmm, ell, spmm, spmv
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
from saddle_point_petsc_tpu_torch.solvers import amg, ilu_stencil, multigrid, precond, refine
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.utils import monitor
from saddle_point_petsc_tpu_torch.utils.options import Options

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(kernel):
    """The launches of kernel `kernel` ("B1" .. "B6") since the last reset."""
    return monitor.counters.get(f"{kernel}.launches", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_matches_plain(dev, dtype, tol):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for nx, ny in ((1, 1), (4, 4), (7, 5), (33, 17), (130, 67)):
        planes = torch.randn((4, 3, 3, ny, nx), generator=gen, dtype=dtype, device=dev)
        x = torch.randn((2, ny, nx), generator=gen, dtype=dtype, device=dev)
        xp = torch.randn((2, ny + 2, nx + 2), generator=gen, dtype=dtype, device=dev)
        monitor.reset_counters()
        y, yp = spmv.stencil_spmv(planes, x), spmv.stencil_spmv_padded(planes, xp)
        assert _launches("B1") == 2
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
    monitor.reset_counters()
    y = A(x)
    assert _launches("B1") == 1
    ref = spmv.planes_matvec_field(A.planes, x)
    assert (y - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


def test_cli_on_card_matches_cpu(dev):
    argv = ["-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "17",
            "-da_grid_y", "17", "-dtype", "f64", "-ksp_rtol", "1e-8", "-no_vtk"]
    monitor.reset_counters()
    card = cli.run(argv + ["-device", "cuda"])
    launches = _launches("B1")
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
        monitor.reset_counters()
        y2, y1 = dia.dia_spmv_2d(data, x, offs), dia.dia_spmv(data, x, offs)
        assert _launches("B3") == 2
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
            monitor.reset_counters()
            y = bdia.bdia_spmv_2d(data, xb, offs, active)
            assert _launches("B4") == 1
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
    monitor.reset_counters()
    ya, yb, ref = A(x), B(x), csr(x)
    assert _launches("B3") == 1 and _launches("B4") == 1
    for got in (ya, yb):
        assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


def test_cli_gamg_on_card_matches_cpu(dev):
    argv = ["-mat_type", "dia", "-ksp_type", "cg", "-pc_type", "gamg", "-da_grid_x", "33",
            "-da_grid_y", "33", "-dtype", "f64", "-ksp_rtol", "1e-8", "-no_vtk"]
    monitor.reset_counters()
    card = cli.run(argv + ["-device", "cuda"])
    launches = _launches("B3")
    host = cli.run(argv + ["-device", "cpu"])
    assert card.rc == host.rc == 0
    assert launches >= card.result.iterations
    assert abs(card.result.iterations - host.result.iterations) <= 1
    x_card, x_host = card.result.x.cpu(), host.result.x
    assert (x_card - x_host).norm() <= 1e-6 * x_host.norm()


def _within(got, ref, tol):
    return (got - ref).abs().max().item() <= tol * max(ref.abs().max().item(), 1e-300)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_spmm_kernel_matches_plain(dev, dtype, tol):
    """B2 against its plain version, and each field against B1 on it alone."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for nx, ny in ((1, 1), (4, 4), (7, 5), (33, 17), (130, 67)):
        planes = torch.randn((4, 3, 3, ny, nx), generator=gen, dtype=dtype, device=dev)
        for k in (1, 3, 8):
            XT = torch.randn((k, 2, ny, nx), generator=gen, dtype=dtype, device=dev)
            monitor.reset_counters()
            Y = spmm.stencil_spmm(planes, XT)
            assert _launches("B2") == 1
            torch.cuda.synchronize()
            assert _within(Y, spmm.planes_matmat_field(planes, XT), tol)
            for j in range(k):
                assert _within(Y[j], spmv.stencil_spmv(planes, XT[j]), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_ell_kernel_matches_plain(dev, dtype, tol):
    """B5 on random slot-major ELL with padding slots, rows not a multiple
    of 32 and widths 1 to 64."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for m, width in ((1, 1), (37, 7), (1000, 64), (1000, 1)):
        cols_t = torch.randint(0, m, (width, m), generator=gen, device=dev, dtype=torch.int32)
        pad = torch.rand((width, m), generator=gen, device=dev) < 0.3
        cols_t = torch.where(pad, -1, cols_t).to(torch.int32)
        vals_t = torch.randn((width, m), generator=gen, dtype=dtype, device=dev)
        x = torch.randn((m,), generator=gen, dtype=dtype, device=dev)
        monitor.reset_counters()
        y = ell.ell_spmv(cols_t, vals_t, x)
        assert _launches("B5") == 1
        torch.cuda.synchronize()
        assert _within(y, ell.ell_spmv_plain(cols_t, vals_t, x), tol)


_B6_OFFSETS = (
    (0,),
    (-37, -1, 0, 1, 37),
    (-300, -17, -1, 0, 3, 129, 255),
    (3, -5000, 0, 5000, 1, -64, 64, -2, 2, -3),  # unsorted, gaps wider than a tile's rows
    tuple(range(-10, 11)),
    tuple(range(-2000, 2000, 97)),
)


@pytest.mark.parametrize("path", [None, "strided", "rows", "blocked"])
@pytest.mark.parametrize("layout", ["rows", "(k,n).T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_spmm_kernel_matches_plain(dev, dtype, layout, path):
    """B6 with X row-major and as the transpose of a (k, n) batch, k from 1
    to past two column chunks, n from 1 up, offsets beyond the rows, gaps
    wider than a tile's rows and padding entries of `data` that are not
    finite: the bits of its plain version and of B3 column by column (both
    round each product and sum in offset order), through the path the
    wrapper picks (None) and through each path forced where it applies (the
    row path: row-major X with k a multiple of 8; the blocked path:
    column-contiguous X and offsets whose plan fits, which the wrapper
    refuses otherwise)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for n in (1, 31, 1000, 100003):
        for offs in _B6_OFFSETS:
            data = torch.randn((len(offs), n), generator=gen, dtype=dtype, device=dev)
            for d, off in enumerate(offs):  # padding: entries that meet no row of X
                if off > 0:
                    data[d, max(n - off, 0):] = float("nan")
                elif off < 0:
                    data[d, : min(-off, n)] = float("inf")
            for k in (1, 4, 8, 9, 16, 17):
                rows = torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
                X = rows if layout == "rows" else rows.T.contiguous().T
                if path == "rows" and not dia_spmm._rows_aligned(X, X):
                    continue
                if path == "blocked" and X.stride(0) != 1:
                    continue
                if path == "blocked" and dia_spmm._plan(offs, n) is None:
                    with pytest.raises(ValueError):
                        dia_spmm._launch(data, X, offs, path=path)
                    continue
                monitor.reset_counters()
                Y = dia_spmm.dia_spmm(data, X, offs) if path is None else dia_spmm._launch(
                    data, X, offs, path=path)
                assert _launches("B6") == 1 and (k == 1 or Y.stride() == X.stride())
                torch.cuda.synchronize()
                assert torch.equal(Y, dia_spmm.dia_spmm_plain(data, X, offs)), (n, offs, k)
                for j in range(k):
                    assert torch.equal(Y[:, j], dia.dia_spmv_2d(data, X[:, j].contiguous(), offs))


def test_new_wrappers_reject_mixed_devices(dev):
    f64 = torch.float64
    with pytest.raises(ValueError):
        spmm.stencil_spmm(torch.zeros((4, 3, 3, 5, 6), dtype=f64),
                          torch.zeros((2, 2, 5, 6), dtype=f64, device=dev))
    with pytest.raises(ValueError):
        ell.ell_spmv(torch.zeros((2, 5), dtype=torch.int32), torch.zeros((2, 5), dtype=f64),
                     torch.zeros((5,), dtype=f64, device=dev))
    with pytest.raises(ValueError):
        dia_spmm.dia_spmm(torch.zeros((1, 5), dtype=f64), torch.zeros((5, 2), dtype=f64, device=dev), (0,))


def _mat_solve(A, B, argv):
    ksp = KSP(Options(["-ksp_type", "cg", "-ksp_rtol", "1e-8"] + argv))
    ksp.set_operators(A).set_from_options()
    return ksp, ksp.mat_solve(B)


@pytest.mark.parametrize("fmt", ["stencil", "dia"])
def test_mat_solve_on_card_launches_kernels(dev, fmt):
    """KSPMatSolve on a CUDA stencil launches B2, on a CUDA DIA B6, once
    per iteration at least, and matches the same solve on the CPU."""
    if fmt == "stencil":
        prob = poisson.assemble_poisson(24, 24, dtype=torch.float64, device=dev)
        A, f, kernel = prob.A, prob.f, "B2"
    else:
        csr, f, _, _ = poisson.assemble_poisson_csr(24, 24, device=dev)
        A, kernel = sparse.csr_to_dia(csr)[0], "B6"
    B = torch.stack([f, 2.0 * f, f * f])
    monitor.reset_counters()
    _, card = _mat_solve(A, B, ["-pc_type", "jacobi"])
    launches = _launches(kernel)
    A_cpu = (StencilOperator(A.planes.cpu()) if fmt == "stencil"
             else sparse.DIA(A.data.cpu(), A.offsets, A.shape))
    _, host = _mat_solve(A_cpu, B.cpu(), ["-pc_type", "jacobi"])
    assert card.converged_reason.tolist() == host.converged_reason.tolist() == [2, 2, 2]
    assert launches >= card.iterations
    assert abs(card.iterations - host.iterations) <= 1
    assert (card.x.cpu() - host.x).norm() <= 1e-9 * host.x.norm()


def test_gamg_on_card_launches_ell_kernel(dev):
    """gamg on 49 x 49 nodes with a coarse limit of 50 has four ELL levels:
    on the card each of their matvecs launches B5, and KSPMatSolve
    launches B6 and B3 as well."""
    csr, f, _, _ = poisson.assemble_poisson_csr(48, 48, device=dev)
    A = sparse.csr_to_dia(csr)[0]
    B = torch.stack([f, 2.0 * f, f * f])
    monitor.reset_counters()
    ksp, res = _mat_solve(A, B, ["-pc_type", "gamg", "-pc_gamg_coarse_eq_limit", "50"])
    assert sum(isinstance(lvl.A, amg._EllOp) for lvl in ksp.M.levels) == 4
    assert _launches("B5") > 0 and _launches("B3") > 0 and _launches("B6") >= res.iterations
    assert res.converged_reason.tolist() == [2, 2, 2] and abs(res.iterations - 8) <= 1
    ell_lvl = next(lvl.A for lvl in ksp.M.levels if isinstance(lvl.A, amg._EllOp))
    x = torch.randn((ell_lvl.ell.shape[1],), dtype=torch.float64, device=dev)
    monitor.reset_counters()
    y = ell_lvl(x)
    assert _launches("B5") == 1
    assert _within(y, ell.ell_spmv_plain(ell_lvl.ell.cols_t, ell_lvl.ell.vals_t, x), 1e-12)


_F32_F64 = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


@pytest.mark.parametrize("smoother", ["chebyshev", "sor"])
@pytest.mark.parametrize("dtype,tol", _F32_F64)
def test_vcycle_on_card_matches_cpu(dev, dtype, tol, smoother):
    """The MG V-cycle on 33^2 nodes (three levels and a 5^2 coarsest) built
    and applied on the card, against the same on the CPU: B1 launches on
    the card, none on the CPU."""
    A = poisson.assemble_poisson(32, 32, dtype=dtype, device=dev, body_force="trig").A
    A_cpu = StencilOperator(A.planes.cpu())
    r = torch.randn((2, 33, 33), dtype=dtype, device=dev)
    M = multigrid.mg_pc(A, smoother=smoother)
    monitor.reset_counters()
    z = M(r)
    assert _launches("B1") >= 2 * len(M.levels)
    monitor.reset_counters()
    z_cpu = multigrid.mg_pc(A_cpu, smoother=smoother)(r.cpu())
    assert _launches("B1") == 0
    assert _within(z.cpu(), z_cpu, tol)


def test_mg_coarsest_inverted_on_card(dev):
    """At 71^2 nodes (one Galerkin level, then config 5's 36^2 coarsest,
    2,592 dofs, f64) mg_pc builds the dense matrix on the card with the
    CPU's bits and inverts it there: within 1e-12 of numpy's inverse,
    relative to its largest entry. MGCoarse.device moves by exactly 1 a
    mg_pc, and not for a singular coarsest, which raises."""
    import numpy as np

    A = poisson.assemble_poisson(70, 70, dtype=torch.float64, device=dev, body_force="trig").A
    monitor.reset_counters()
    M = multigrid.mg_pc(A)
    assert len(M.levels) == 1 and monitor.counters["MGCoarse.device"] == 1
    ci = M.coarse_inv
    assert ci.is_cuda and ci.is_contiguous() and ci.shape == (2592, 2592) and ci.dtype == torch.float64
    coarse = multigrid.galerkin_coarse_stencil(A)
    dense = multigrid._stencil_to_dense(coarse.planes)
    assert dense.is_cuda and torch.equal(dense.cpu(), multigrid._stencil_to_dense(coarse.planes.cpu()))
    ref = np.linalg.inv(dense.cpu().numpy())
    assert np.abs(ci.cpu().numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    multigrid.mg_pc(A)
    assert monitor.counters["MGCoarse.device"] == 2
    planes = torch.zeros((4, 3, 3, 5, 5), dtype=torch.float64, device=dev)
    planes[0, 1, 1] = planes[3, 1, 1] = 1.0
    planes[:, 1, 1, 2, 3] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        multigrid.mg_pc(StencilOperator(planes))
    assert monitor.counters["MGCoarse.device"] == 2


@pytest.mark.parametrize("order", ["symmetric", "forward"])
@pytest.mark.parametrize("dtype,tol", _F32_F64)
def test_sor_on_card_matches_cpu(dev, dtype, tol, order):
    A = poisson.assemble_poisson(20, 13, dtype=dtype, device=dev, body_force="trig").A
    r = torch.randn((2, 14, 21), dtype=dtype, device=dev)
    monitor.reset_counters()
    z = precond.sor(A, sweeps=2, order=order)(r)
    assert _launches("B1") == 2 * (4 if order == "symmetric" else 2)
    monitor.reset_counters()
    z_cpu = precond.sor(StencilOperator(A.planes.cpu()), sweeps=2, order=order)(r.cpu())
    assert _launches("B1") == 0
    assert _within(z.cpu(), z_cpu, tol)


def test_refinement_cycle_on_card_matches_cpu(dev):
    """One refinement cycle (solve_refined) on the 17^2 Poisson system: the
    f64 residual through B1 in f64 (to 1e-12), then an f32 correction of
    exactly ten Jacobi-CG iterations (to 1e-5 of max|x|; a solve to a
    tolerance could stop an iteration apart on the two devices)."""
    prob = poisson.assemble_poisson(16, 16, dtype=torch.float64, device=dev, body_force="trig")
    out = []
    for device in (dev, torch.device("cpu")):
        planes = prob.A.planes.to(device)
        A32 = StencilOperator(planes.float())
        monitor.reset_counters()
        res = refine.solve_refined(A32, prob.f.to(device), refine.inner_cg(A32, M=precond.jacobi(A32), rtol=0.0,
                                                                            maxiter=10), max_cycles=1)
        out.append((res, _launches("B1")))
    (card, n_card), (host, n_host) = out
    assert n_card > card.inner_iterations == 10 and n_host == 0
    assert card.cycles == host.cycles == 1 and card.x.dtype == torch.float64
    assert _within(card.x.cpu(), host.x, 1e-5)
    # the f64 residual of the same x on both devices
    A64 = StencilOperator(prob.A.planes)
    r_card = prob.f - A64(card.x)
    r_host = prob.f.cpu() - StencilOperator(prob.A.planes.cpu())(card.x.cpu())
    assert _within(r_card.cpu(), r_host, 1e-12)


@pytest.mark.parametrize("dtype,tol", _F32_F64)
def test_stencil_ilu_on_card_matches_cpu(dev, dtype, tol):
    """StencilILU0PC built and applied on the card against the same on the
    CPU: exactly 12 B1 launches per apply at 6 sweeps (none on the CPU);
    then the CSR's exact level-scheduled solves (sweeps 0) on the card."""
    A = poisson.assemble_poisson(20, 13, dtype=dtype, device=dev, body_force="trig").A
    A_cpu = StencilOperator(A.planes.cpu())
    r = torch.randn((2, 14, 21), dtype=dtype, device=dev)
    M = ilu_stencil.stencil_ilu0(A, sweeps=6)
    assert M.Lp.is_cuda and M.Lp.dtype == dtype
    monitor.reset_counters()
    z = M(r)
    assert _launches("B1") == 12
    monitor.reset_counters()
    z_cpu = ilu_stencil.stencil_ilu0(A_cpu, sweeps=6)(r.cpu())
    assert _launches("B1") == 0
    assert _within(z.cpu(), z_cpu, tol)
    csr = poisson.assemble_poisson_csr(20, 13, dtype=dtype, device=dev)[0]
    csr_cpu = poisson.assemble_poisson_csr(20, 13, dtype=dtype, device="cpu")[0]
    M0 = precond.ilu0(csr, sweeps=0)
    assert M0.lower.vals.is_cuda and M0.upper.scale.is_cuda
    z0 = M0(r)
    assert z0.is_cuda
    assert _within(z0.cpu(), precond.ilu0(csr_cpu, sweeps=0)(r.cpu()), tol)


@pytest.fixture
def nccl_world(dev):
    """A world of one over NCCL on the card (an in-process store),
    destroyed at the end."""
    import torch.distributed as dist

    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh

    d, created = pmesh.init_from_env(dev)
    assert created and dist.get_backend() == "nccl"
    yield pmesh.ProcessMesh.create(device=d)
    dist.destroy_process_group()


def test_process_mesh_default_device_is_the_card(nccl_world):
    """ProcessMesh.create() with no device holds its patches on the current
    card, and the distributed assembly puts them there."""
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist
    from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh

    m = pmesh.ProcessMesh.create()
    assert m.device == torch.device("cuda", torch.cuda.current_device()) == nccl_world.device
    A, f, mask = pdist.assemble_poisson_dist(pdist.DistGrid.create(16, 16, m))
    assert A.planes.is_cuda and f.is_cuda and mask.is_cuda


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "padded"])
def test_dist_matvec_world_of_one_on_card(nccl_world, overlap):
    """Both forms of the distributed matvec in a world of one on the card:
    the assembly within 4 ulp of the serial one (kernel FE against the
    batched products), the serial B1 result (to B1's own bounds), through
    B1's local entry (the operator's matvec, overlap form) or its padded
    entry (one field through `matmat_field`), one launch each; the halo
    exchange and halo_add against zero padding and cropping."""
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist
    from saddle_point_petsc_tpu_torch.parallel import halo

    A, f, _ = pdist.assemble_poisson_dist(pdist.DistGrid.create(40, 27, nccl_world), dtype=torch.float32)
    serial = poisson.assemble_poisson(40, 27, dtype=torch.float32, device=nccl_world.device)
    # kernel FE sums in its own order: within rounding of the serial operator
    assert _fe_within(A.planes, serial.A.planes, torch.float32) and _fe_within(f, serial.f, torch.float32, "load")
    x = torch.randn((2, 28, 41), dtype=torch.float32, device=nccl_world.device)
    xp = halo.halo_exchange_1phase(x, nccl_world)
    assert torch.equal(xp, torch.nn.functional.pad(x, (1, 1, 1, 1)))
    assert torch.equal(halo.halo_add(xp, nccl_world), x)
    monitor.reset_counters()
    y = A(x) if overlap else A.matmat_field(x[None])[0]
    entry = "B1.launches.local" if overlap else "B1.launches.padded"
    assert _launches("B1") == monitor.counters[entry] == monitor.counters["B1.launches.float32"] == 1
    assert _within(y.cpu(), serial.A(x).cpu(), 1e-5)


def test_dist_cli_world_of_one_on_card(nccl_world):
    """The CLI's -dist saddle route with BASELINE config 4's solver on the
    card, in the world of one (reused, not destroyed by the run), against
    the serial route with the PC the 1 x 1 mesh reduces to: the same
    iteration count and solution, B1 launched every iteration. The routes'
    operators differ by rounding (kernel FE against the batched products,
    4 ulp in f32), which f32 MINRES carries into x: 45 iterations each and
    max|dx| / max|x| = 1.83e-6 on an H100, held to 2.5e-6."""
    import torch.distributed as dist

    common = ["-device", "cuda", "-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", "65",
              "-da_grid_y", "65", "-dtype", "f32", "-ksp_rtol", "1e-5", "-no_vtk"]
    monitor.reset_counters()
    d = cli.run(common + ["-dist", "-fieldsplit_inner_pc_type", "bjacobi", "-sub_pc_type", "chebyshev",
                          "-pc_bjacobi_local_its", "4"])
    launches = _launches("B1")
    s = cli.run(common + ["-fieldsplit_inner_pc_type", "chebyshev", "-pc_chebyshev_esteig",
                          "-pc_chebyshev_its", "4"])
    assert dist.is_initialized()
    assert d.rc == s.rc == 0 and d.result.iterations == s.result.iterations
    assert launches >= d.result.iterations
    assert _within(d.result.x[0].cpu(), s.result.x[0].cpu(), 2.5e-6)


@pytest.mark.parametrize("route", ["dist", "serial"])
@pytest.mark.parametrize("n", [71, 141])
def test_kkt_minres_mg_count_on_card(nccl_world, n, route):
    """BASELINE config 5's solver (MINRES, Schur(diag), a Chebyshev MG
    A-block, rtol 1e-8, f64) on the card at n^2 nodes, whose MG ends on
    config 5's 36^2 coarsest, inverted on the card: 6 iterations on both
    routes, the count an H100 gave with the inverse formed by numpy on the
    host."""
    argv = ["-device", "cuda", "-problem_type", "saddle", "-body_force", "trig", "-da_grid_x", str(n),
            "-da_grid_y", str(n), "-dtype", "f64", "-no_vtk", "-ksp_type", "minres", "-pc_type", "fieldsplit",
            "-pc_fieldsplit_schur_fact_type", "diag", "-fieldsplit_inner_pc_type", "mg",
            "-pc_mg_smoother", "chebyshev", "-ksp_rtol", "1e-8", "-ksp_max_it", "500"]
    monitor.reset_counters()
    r = cli.run(argv + (["-dist"] if route == "dist" else []))
    assert r.rc == 0 and r.result.iterations == 6
    assert monitor.counters["MGCoarse.device"] == 1


# kernel FE (csrc/q1_assembly.cu) against its plain version: one rank's
# patches of partitioned grids, (nex, ney, (py, px), (pj, pi)), as in
# tests/test_torch_fe_assembly.py, and BASELINE config 4's grid in a world of one
FE_PATCHES = {
    "unpadded": (15, 15, (2, 2), (0, 0)),
    "padded": (16, 13, (2, 2), (1, 1)),
    "no_elements": (12, 9, (1, 4), (0, 3)),
    "config4": (703, 703, (1, 1), (0, 0)),
}


def _fe_within(got, want, dtype, label="planes"):
    """Kernel FE against the batched products, which sum in another order:
    in f64 1e-12 absolute for the planes (entries of order 1), 1e-12 of
    max|want| for loads and constraint rows (entries of order h^2); 4 ulp
    of max|want| in f32."""
    scale = want.abs().max().item()
    if dtype == torch.float32:
        tol = 4 * torch.finfo(torch.float32).eps * scale
    else:
        tol = 1e-12 if label == "planes" else 1e-12 * scale
    return got.shape == want.shape and got.dtype == want.dtype and (got - want).abs().max().item() <= tol


def _fe_patch(spec, dtype, dev):
    """(xs, ys, my, mx) of the patch (nex, ney, (py, px), (pj, pi))."""
    import types

    from saddle_point_petsc_tpu_torch.parallel import dist as pdist

    nex, ney, (py, px), (pj, pi) = spec
    grid = pdist.DistGrid.create(nex, ney, types.SimpleNamespace(py=py, px=px, pj=pj, pi=pi))
    return (*pdist._local_axes(grid, dtype, dev), grid.my, grid.mx)


@pytest.mark.parametrize("patch", list(FE_PATCHES))
@pytest.mark.parametrize("force", ["constant", "trig"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fe_kernel_matches_plain(dev, patch, force, dtype):
    """In f64 planes to 1e-12, loads and rows to 1e-12 of their largest
    entry; 4 ulp of the largest entry in f32; one launch, counted by type."""
    from saddle_point_petsc_tpu_torch.ops.cuda import assembly
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist

    xs, ys, my, mx = _fe_patch(FE_PATCHES[patch], dtype, dev)
    monitor.reset_counters()
    got = assembly.q1_assemble(xs, ys, my, mx, force=force, rows=True)
    torch.cuda.synchronize()
    assert monitor.counters["FE.launches"] == monitor.counters[f"FE.launches.{str(dtype)[6:]}"] == 1
    want = pdist._accumulators_plain(xs, ys, my, mx, body_force=force, rows=True)
    for label, g, w in zip(("planes", "load", "rows"), got, want):
        assert g.is_cuda and _fe_within(g, w, dtype, label), label


def test_fe_kernel_matches_plain_at_config5(dev):
    """BASELINE config 5's 2241^2 grid in f64 (a world of one): planes to
    1e-12, load and rows to 1e-12 of their largest entry."""
    from saddle_point_petsc_tpu_torch.ops.cuda import assembly
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist

    xs, ys, my, mx = _fe_patch((2240, 2240, (1, 1), (0, 0)), torch.float64, dev)
    got = assembly.q1_assemble(xs, ys, my, mx, force="trig", rows=True)
    # one plain accumulator at a time: the batched products of all three
    # hold ~13 GB at this size
    for i, label in enumerate(("planes", "load", "rows")):
        want = pdist._accumulators_plain(xs, ys, my, mx, body_force="trig" if i == 1 else None,
                                         planes=i == 0, rows=i == 2)[i]
        assert _fe_within(got[i], want, torch.float64, label), label
        del want


def test_fe_kernel_callable_force_on_card(nccl_world):
    """A callable body force on the -dist route: one launch of the kernel
    writes planes and rows, the load comes from the batched products
    (fem.element_rhs), bit for bit."""
    from saddle_point_petsc_tpu_torch.models import fem
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist

    grid = pdist.DistGrid.create(40, 27, nccl_world)
    monitor.reset_counters()
    got = pdist._accumulators(grid, torch.float64, fem.trig_body_force, rows=True)
    assert monitor.counters["FE.launches"] == 1
    xs, ys = pdist._local_axes(grid, torch.float64, nccl_world.device)
    want = pdist._accumulators_plain(xs, ys, grid.my, grid.mx, body_force=fem.trig_body_force, rows=True)
    assert torch.equal(got[1], want[1])
    assert _fe_within(got[0], want[0], torch.float64) and _fe_within(got[2], want[2], torch.float64, "rows")


def test_dist_assembly_launches_fe_once_on_card(nccl_world):
    """One FE launch an assembly on one rank: assemble_saddle_dist writes
    planes, load and rows in one; the result within rounding of the serial
    KKT system (f64: planes 1e-12, f and Bf 1e-12 of their largest
    entry)."""
    from saddle_point_petsc_tpu_torch.models import saddle
    from saddle_point_petsc_tpu_torch.parallel import dist as pdist

    grid = pdist.DistGrid.create(40, 27, nccl_world)
    monitor.reset_counters()
    K, (f, g), mask = pdist.assemble_saddle_dist(grid)
    assert monitor.counters["FE.launches"] == monitor.counters["FE.launches.float64"] == 1
    serial = saddle.assemble_saddle(40, 27, device=nccl_world.device, body_force="trig")
    assert _fe_within(K.A.planes, serial.K.A.planes, torch.float64)
    assert _fe_within(f, serial.f, torch.float64, "load") and _fe_within(K.Bf, serial.K.Bf, torch.float64, "rows")
    assert torch.equal(mask, serial.bc_mask) and torch.equal(g, serial.g)
    A, _, mask = pdist.assemble_poisson_dist(grid, dtype=torch.float32)
    pdist.assemble_constraints_dist(grid, mask, dtype=torch.float32)
    assert monitor.counters["FE.launches"] == 3 and monitor.counters["FE.launches.float32"] == 2


def _q1_dist_aij(mesh, n, dtype, dia="auto"):
    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    csr = poisson.assemble_poisson_csr(n - 1, n - 1, dtype=dtype, device=mesh.device)[0]
    return csr, dist_csr.dist_aij_from_scipy(sparse.csr_to_scipy(csr), mesh, dtype=dtype, dia=dia)


def test_make_mesh_1d_default_device_is_the_card(nccl_world):
    """make_mesh_1d() with no device holds its rows on the current card."""
    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    m = dist_csr.make_mesh_1d()
    assert m.device == nccl_world.device and m.shape == (1, 1)
    _, A = _q1_dist_aij(m, 17, torch.float32)
    assert A.diag_vals_t.is_cuda and A.dia_data.is_cuda and A.diagonal().is_cuda


@pytest.mark.parametrize("dtype,tol", _F32_F64)
@pytest.mark.parametrize("bands", ["auto", "off"])
def test_dist_aij_world_of_one_on_card(nccl_world, dtype, tol, bands):
    """A DistAIJ in a world of one on the card: its matvec launches B3
    (banded copy) or B5 (ELL) once and matches the serial CSR matvec, its
    matmat at k = 4 launches B6 once on the banded copy, and its per-rank
    ILU(0) apply launches B5 2 x 6 times; each against its plain version
    (the CPU build of the same operator)."""
    import dataclasses

    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    csr, A = _q1_dist_aij(nccl_world, 33, dtype, bands)
    cpu = dataclasses.replace(nccl_world, device=torch.device("cpu"))
    A_cpu = dist_csr.dist_aij_from_scipy(sparse.csr_to_scipy(csr), cpu, dtype=dtype, dia=bands)
    x = torch.randn((A.n_pad,), dtype=dtype, device=nccl_world.device)
    monitor.reset_counters()
    y = A.matvec(x)
    assert (_launches("B3"), _launches("B5")) == ((1, 0) if bands == "auto" else (0, 1))
    assert _within(y.cpu(), csr.matvec(x).cpu(), tol) and _within(y.cpu(), A_cpu.matvec(x.cpu()), tol)
    X = torch.randn((A.n_pad, 4), dtype=dtype, device=nccl_world.device)
    monitor.reset_counters()
    Y = A.matmat(X)
    assert _launches("B6") == (1 if bands == "auto" else 0)
    assert _within(Y.cpu(), A_cpu.matmat(X.cpu()), tol)
    M, M_cpu = dist_csr.dist_aij_ilu0(A, sweeps=6), dist_csr.dist_aij_ilu0(A_cpu, sweeps=6)
    monitor.reset_counters()
    z = M(x)
    assert _launches("B5") == 12
    assert _within(z.cpu(), M_cpu(x.cpu()), tol)


def test_dist_aij_cli_world_of_one_on_card(nccl_world):
    """The CLI's -mat_type aij -dist at 65^2 on the card in the world of one
    against the serial -mat_type aij route: the same iteration count (f64,
    CG + Jacobi), B3 launched every iteration."""
    common = ["-device", "cuda", "-mat_type", "aij", "-da_grid_x", "65", "-da_grid_y", "65", "-dtype", "f64",
              "-ksp_type", "cg", "-ksp_rtol", "1e-8", "-no_vtk"]
    monitor.reset_counters()
    d = cli.run(common + ["-dist"])
    launches = _launches("B3")
    s = cli.run(common)
    assert d.rc == s.rc == 0 and d.result.iterations == s.result.iterations
    assert launches >= d.result.iterations
    assert _within(d.result.x.cpu(), s.result.x.cpu(), 1e-9)


def test_gamg_stream_setup_on_card_matches_cpu(nccl_world):
    """CG + the streaming gamg set-up on the 5-point Laplacian (128^2 rows,
    f32) on the card: each level's rows and entries, and the GAMG counters,
    equal those of the CPU build of the same DistAIJ; the solve launches B3
    (the banded levels) and B5 (the transfers)."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sps

    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    m = 128
    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    a = (sps.kron(sps.identity(m), t) + sps.kron(t, sps.identity(m))).tocsr()
    argv = ["-ksp_type", "cg", "-pc_type", "gamg", "-pc_gamg_setup", "stream", "-ksp_rtol", "1e-6"]
    built = {}
    for mesh in (dataclasses.replace(nccl_world, device=torch.device("cpu")), nccl_world):
        A = dist_csr.dist_aij_from_rows(a, m * m, mesh, dtype=np.float32)
        monitor.reset_counters()
        ksp = KSP(Options(argv)).set_operators(A).set_from_options().set_up()
        levels = [(lvl.A.shape[0], lvl.A.to_scipy_rows()[: lvl.A.shape[0]].nnz) for lvl in ksp.M.levels]
        counts = {k: v for k, v in monitor.counters.items() if k.startswith("GAMG.")}
        built[mesh.device.type] = (levels, counts, ksp, A)
    assert built["cuda"][0] == built["cpu"][0] and len(built["cuda"][0]) >= 2
    assert built["cuda"][1] == built["cpu"][1] and built["cuda"][1]["GAMG.levels"] == len(built["cuda"][0]) + 1
    _, _, ksp, A = built["cuda"]
    monitor.reset_counters()
    res = ksp.solve(torch.ones(A.n_pad, dtype=torch.float32, device=nccl_world.device))
    assert res.converged_reason > 0
    assert _launches("B3") > 0 and _launches("B5") > 0


# the device memory the gamg cell's set-up holds at its peak (PERF.md §4)
GAMG_CELL_PEAK_BYTES = 422_022_144


def test_dist_aij_build_on_card_matches_cpu(nccl_world):
    """The gamg cell's DistAIJ builds on the card, from the 1,048,576-row
    5-point operator's rows and its first level's P, R and Ac rows, equal
    the same builds on the CPU mesh from the same rows, field by field and
    bit for bit; the first level built from each operator counts the same
    `GAMG.*`; the operator's build stays under the cell's set-up peak in
    device memory."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sps

    from saddle_point_petsc_tpu_torch.parallel import dist_csr

    m = 1024
    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    a = (sps.kron(sps.identity(m), t) + sps.kron(t, sps.identity(m))).tocsr()
    cpu = dataclasses.replace(nccl_world, device=torch.device("cpu"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    A = dist_csr.dist_aij_from_rows(a, m * m, nccl_world, dtype=np.float32)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < GAMG_CELL_PEAK_BYTES and A.dia_data is not None
    A_cpu = dist_csr.dist_aij_from_rows(a, m * m, cpu, dtype=np.float32)
    counts = {}
    for op in (A_cpu, A):
        monitor.reset_counters()
        level, Ac, Ac_rows, _ = amg._dist_amg_stream_level(op, 0.08, 2)
        counts[op.mesh.device.type] = {k: v for k, v in monitor.counters.items() if k.startswith("GAMG.")}
    assert counts["cuda"] == counts["cpu"] and counts["cpu"]["GAMG.levels"] == 1
    n, na = m * m, Ac.shape[0]
    builds = [(a, n, None), (level.P.to_scipy_rows(), na, n), (level.R.to_scipy_rows(), n, na), (Ac_rows, na, None)]
    fields = ("diag_cols_t", "diag_vals_t", "off_cols_t", "off_vals_t", "send_idx", "dia_data", "ghost_cols",
              "dia_offsets", "shape", "n_pad", "n_pad_col", "has_ghosts")
    for k, (rows, n_cols, n_rows) in enumerate(builds):
        got = A if k == 0 else dist_csr.dist_aij_from_rows(rows, n_cols, nccl_world, dtype=np.float32, n_rows=n_rows)
        want = A_cpu if k == 0 else dist_csr.dist_aij_from_rows(rows, n_cols, cpu, dtype=np.float32, n_rows=n_rows)
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if isinstance(w, torch.Tensor):
                assert g.is_cuda and g.dtype == w.dtype and torch.equal(g.cpu(), w), (k, f)
            elif isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and np.array_equal(g, w), (k, f)
            else:
                assert g == w, (k, f, g, w)


# kernel RN (csrc/normal_draw.cu) against its CPU twin: odd sizes, a seed
# above 32 bits, leaves 0 and 3
RN_DRAWS = [(1, 0, 0), (3, 7, 3), (1001, (1 << 40) + 11, 0), ((1 << 20) + 7, 2**31 + 5, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,seed,leaf", RN_DRAWS)
def test_rn_kernel_matches_twin(dev, dtype, n, seed, leaf):
    """The Philox words bit-equal to the twin's (so the uniforms are too);
    the normals within 4 ulp of the twin's (log, sin and cos are the card's
    against numpy's; a float32 draw is the f64 one rounded); one launch
    counted by type."""
    import numpy as np

    from saddle_point_petsc_tpu_torch.ops.cuda import rng

    pairs = (n + 1) // 2
    words = rng.philox_words(pairs, seed, leaf, device=dev)
    monitor.reset_counters()
    z = rng.normal_(torch.empty(n, dtype=dtype, device=dev), seed, leaf)
    assert _launches("RN") == monitor.counters[f"RN.launches.{str(dtype)[6:]}"] == 1
    torch.cuda.synchronize()
    assert np.array_equal(words.cpu().numpy().view(np.uint32), rng.philox_words_plain(pairs, seed, leaf))
    want = rng.normal_plain(n, seed, leaf).astype(str(dtype)[6:])
    got = z.cpu().numpy()
    assert (np.abs(got - want) <= 4 * np.spacing(np.abs(want))).all()


def test_estimate_lmax_on_card_matches_cpu(dev):
    """estimate_lmax of Jacobi-preconditioned A at 65^2 nodes in f64 on the
    card, against the same on CPU tensors, within 1e-13 relative: one RN
    launch on the card, none on the CPU."""
    A = poisson.assemble_poisson(64, 64, dtype=torch.float64, device=dev, body_force="trig").A
    A_cpu = StencilOperator(A.planes.cpu())
    tmpl = torch.ones((2, 65, 65), dtype=torch.float64)
    monitor.reset_counters()
    lam = precond.estimate_lmax(A, precond.jacobi(A), template=tmpl.to(dev))
    assert _launches("RN") == 1
    monitor.reset_counters()
    lam_cpu = precond.estimate_lmax(A_cpu, precond.jacobi(A_cpu), template=tmpl)
    assert _launches("RN") == 0
    assert abs(lam - lam_cpu) <= 1e-13 * lam_cpu


def test_mg_setup_launches_rn_once_a_level(dev):
    """One Chebyshev MG set-up at 257^2 nodes in f64 draws each level's
    start vector on the card: RN.launches equals the number of Chebyshev
    levels."""
    A = poisson.assemble_poisson(256, 256, dtype=torch.float64, device=dev, body_force="trig").A
    monitor.reset_counters()
    M = multigrid.mg_pc(A, smoother="chebyshev")
    assert _launches("RN") == monitor.counters["RN.launches.float64"] == len(M.levels)
