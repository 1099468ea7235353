"""Kernel FE's algorithm and wrapper on the CPU (ops/cuda/assembly.py,
csrc/q1_assembly.cu).

- The kernel's gather form, written here in numpy (one pass over the padded
  nodes; each node sums node a's rows of the <= 4 elements that touch it,
  corners a = 0..3 in order, each element summed over its Gauss points
  first, the inverse Jacobian as a reciprocal of det times the adjugate),
  against the plain version, parallel/dist.py's `_accumulators_plain`: in
  float64 planes to 1e-12 (entries of order 1), loads and constraint rows
  to 1e-12 of their largest entry (entries of order h^2); in float32, 4 ulp
  of the largest entry (the two sum in different orders). The numpy copy
  holds the kernel's body forces and constraint functionals to those of
  models/fem.py and models/saddle.py, which the plain version calls.
- The wrapper's checks; it takes CUDA tensors only.
- The dispatch: CPU tensors run the plain version, launch nothing, and a
  world of one assembles the serial operator bit for bit.

The kernel itself runs in tests/test_torch_cuda.py and chip_smoke.py.
"""
from __future__ import annotations

import math
import types
from datetime import timedelta

import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu_torch.models import fem
from saddle_point_petsc_tpu_torch.ops.cuda import assembly
from saddle_point_petsc_tpu_torch.parallel import dist as pdist
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.utils import monitor

_GP = 0.57735026919
_NODE_OFF = ((0, 0), (1, 0), (1, 1), (0, 1))


def _gather(xs, ys, my, mx, force):
    """The kernel's arithmetic in numpy, in the coordinates' own type:
    (planes (4, 3, 3, my+2, mx+2), load (2, ...), rows (4, 2, ...))."""
    T = xs.dtype.type
    ej, ei = max(len(ys) - 1, 0), max(len(xs) - 1, 0)
    pj, pi = np.meshgrid(np.arange(my + 2), np.arange(mx + 2), indexing="ij")
    acc = np.zeros((4, 3, 3, my + 2, mx + 2), dtype=xs.dtype)
    fe = np.zeros((2, my + 2, mx + 2), dtype=xs.dtype)
    be = np.zeros((4, my + 2, mx + 2), dtype=xs.dtype)  # rows (0, 0), (1, 1), (2, 0), (3, 1)
    g, one, quarter = T(_GP), T(1), T(0.25)
    for a, (aj, ai) in enumerate(_NODE_OFF):
        e_j, e_i = pj - 1 - aj, pi - 1 - ai
        valid = (e_j >= 0) & (e_j < ej) & (e_i >= 0) & (e_i < ei)
        if not valid.any():
            continue
        jj, ii = np.clip(e_j, 0, ej - 1), np.clip(e_i, 0, ei - 1)
        x0, x1, y0, y1 = xs[ii], xs[ii + 1], ys[jj], ys[jj + 1]
        ke = np.zeros((4, 4, my + 2, mx + 2), dtype=xs.dtype)
        fa = np.zeros((2, my + 2, mx + 2), dtype=xs.dtype)
        ba = np.zeros((4, my + 2, mx + 2), dtype=xs.dtype)
        for p, (pj_, pi_) in enumerate(_NODE_OFF):
            xi, eta = (g if pi_ else -g), (g if pj_ else -g)
            n, gx, ge = [], [], []
            for cj, ci in _NODE_OFF:
                sx, sy = (one if ci else -one), (one if cj else -one)
                n.append(quarter * (one + sx * xi) * (one + sy * eta))
                gx.append(sx * (quarter * (one + sy * eta)))
                ge.append(sy * (quarter * (one + sx * xi)))
            j00 = j01 = j10 = j11 = xp = yp = T(0)
            for i, (cj, ci) in enumerate(_NODE_OFF):
                X, Y = (x1 if ci else x0), (y1 if cj else y0)
                j00, j01 = j00 + gx[i] * X, j01 + gx[i] * Y
                j10, j11 = j10 + ge[i] * X, j11 + ge[i] * Y
                xp, yp = xp + n[i] * X, yp + n[i] * Y
            det = j00 * j11 - j01 * j10
            r = one / det
            i00, i01, i10, i11 = j11 * r, -j01 * r, -j10 * r, j00 * r
            dx = [i00 * gx[i] + i01 * ge[i] for i in range(4)]
            dy = [i10 * gx[i] + i11 * ge[i] for i in range(4)]
            d2 = T(2) * det
            ax2, ay2, ax1, ay1 = dx[a] * d2, dy[a] * d2, dx[a] * det, dy[a] * det
            for b in range(4):
                ke[b, 0] += ax2 * dx[b] + ay1 * dy[b]
                ke[b, 1] += ay1 * dx[b]
                ke[b, 2] += ax1 * dy[b]
                ke[b, 3] += ay2 * dy[b] + ax1 * dx[b]
            if force is not None:
                f0 = np.sin(T(math.pi) * xp) * np.cos(T(math.pi) * yp) if force == "trig" else one
                fa[0] += n[a] * (det * f0)
                fa[1] += n[a] * (det * T(2))
            ba[0] += n[a] * det
            ba[1] += n[a] * det
            ba[2] += n[a] * (det * xp)
            ba[3] += n[a] * (det * yp)
        for b, (bj, bi) in enumerate(_NODE_OFF):
            for k in range(4):
                acc[k, bj - aj + 1, bi - ai + 1] += np.where(valid, ke[b, k], T(0))
        fe += np.where(valid, fa, T(0))
        be += np.where(valid, ba, T(0))
    rows = np.zeros((4, 2, my + 2, mx + 2), dtype=xs.dtype)
    for k, (r_, c) in enumerate(((0, 0), (1, 1), (2, 0), (3, 1))):
        rows[r_, c] = be[k]
    return acc.reshape(4, 3, 3, my + 2, mx + 2), fe, rows


# (nex, ney, (py, px), (pj, pi)): one rank's patch of a partitioned grid
PATCHES = {
    "unpadded": (15, 15, (2, 2), (0, 0)),  # 16^2 nodes, a full 8 x 8 patch: ej = my
    "padded": (16, 13, (2, 2), (1, 1)),  # 17 x 14 nodes on 18 x 14: ej < my, ei < mx, padding
    "no_elements": (12, 9, (1, 4), (0, 3)),  # the last column of ranks owns no element
}


def _patch(name, dtype):
    nex, ney, (py, px), (pj, pi) = PATCHES[name]
    grid = pdist.DistGrid.create(nex, ney, types.SimpleNamespace(py=py, px=px, pj=pj, pi=pi))
    xs, ys = pdist._local_axes(grid, dtype, "cpu")
    return xs, ys, grid.my, grid.mx


def fe_tol(want, dtype, label):
    """Kernel FE against the batched products, which sum in another
    order: in float64 1e-12 absolute for the planes, 1e-12 of max|want|
    for the load and the rows; in float32 4 ulp of max|want|."""
    scale = float(np.abs(want).max())
    if dtype == torch.float32:
        return 4 * float(np.finfo(np.float32).eps) * scale
    return 1e-12 if label == "planes" else 1e-12 * scale


def test_patches_cover_the_cases():
    """The patches are what their names say: a full patch, one at the
    padded far corner, and one without elements."""
    xs, ys, my, mx = _patch("unpadded", torch.float64)
    assert (len(ys) - 1, len(xs) - 1) == (my, mx) == (8, 8)
    xs, ys, my, mx = _patch("padded", torch.float64)
    assert len(ys) - 1 < my and len(xs) - 1 < mx
    xs, ys, my, mx = _patch("no_elements", torch.float64)
    assert len(xs) <= 1 and len(ys) > 1


@pytest.mark.parametrize("patch", list(PATCHES))
@pytest.mark.parametrize("force", ["constant", "trig"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gather_form_matches_plain(patch, force, dtype):
    xs, ys, my, mx = _patch(patch, dtype)
    want = pdist._accumulators_plain(xs, ys, my, mx, body_force=force, rows=True)
    got = _gather(xs.numpy(), ys.numpy(), my, mx, force)
    for label, g, w in zip(("planes", "load", "rows"), got, want):
        w = w.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, label
        np.testing.assert_allclose(g, w, rtol=0, atol=fe_tol(w, dtype, label), err_msg=label)
    if patch == "no_elements":
        assert not any(w.any() for w in want)


def test_plain_outputs_follow_the_flags():
    """Each accumulator only where asked for; a callable body force gives
    the same load as its name."""
    xs, ys, my, mx = _patch("padded", torch.float64)
    Wp, load, rows = pdist._accumulators_plain(xs, ys, my, mx)
    assert Wp.shape == (4, 3, 3, my + 2, mx + 2) and load is None and rows is None
    Wp, load, rows = pdist._accumulators_plain(xs, ys, my, mx, body_force="trig", planes=False, rows=True)
    assert Wp is None and load.shape == (2, my + 2, mx + 2) and rows.shape == (4, 2, my + 2, mx + 2)
    _, called, _ = pdist._accumulators_plain(xs, ys, my, mx, body_force=fem.trig_body_force, planes=False)
    assert torch.equal(called, load)


def test_kernel_knows_the_models_forces_and_rows():
    """The kernel computes every named body force of models/fem.py and the
    four default constraint functionals of models/saddle.py, in that
    order (csrc/q1_assembly.cu writes rows (1, 0), (0, 1), (x, 0), (0, y))."""
    from saddle_point_petsc_tpu_torch.models.saddle import default_constraints

    assert set(assembly.FORCES) == set(fem.BODY_FORCES)
    x, y = torch.tensor([0.25, 0.5]), torch.tensor([0.75, 0.125])
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    want = ((one, zero), (zero, one), (x, zero), (zero, y))
    fns = default_constraints()
    assert len(fns) == len(want)
    for fn, (wx, wy) in zip(fns, want):
        gx, gy = fn(x, y)
        assert torch.equal(gx, wx) and torch.equal(gy, wy)


def _bad(kind):
    xs, ys, my, mx = _patch("padded", torch.float64)
    kw = {}
    if kind == "list":
        xs = xs.tolist()
    elif kind == "mixed_dtype":
        ys = ys.float()
    elif kind == "int_dtype":
        xs, ys = xs.long(), ys.long()
    elif kind == "mixed_device":
        ys = torch.empty(ys.shape, dtype=ys.dtype, device="meta")
    elif kind == "meta_device":
        xs = torch.empty(xs.shape, dtype=xs.dtype, device="meta")
        ys = torch.empty(ys.shape, dtype=ys.dtype, device="meta")
    elif kind == "2d":
        xs = xs[None]
    elif kind == "too_many":
        xs = torch.linspace(0, 1, mx + 2, dtype=xs.dtype)
    elif kind == "zero_patch":
        my = 0
    elif kind == "float_patch":
        mx = float(mx)
    elif kind == "strided":
        xs = torch.linspace(0, 1, 2 * len(xs), dtype=xs.dtype)[::2]
    elif kind == "force":
        kw["force"] = "gravity"
    elif kind == "callable_force":
        kw["force"] = fem.trig_body_force
    return (xs, ys, my, mx), kw


BAD = {
    "list": (TypeError, "torch tensors"),
    "mixed_dtype": (TypeError, "need one of float32, float64"),
    "int_dtype": (TypeError, "need one of float32, float64"),
    "mixed_device": (ValueError, "xs on cpu, ys on meta"),
    "meta_device": (ValueError, "takes CUDA tensors, not meta"),
    "cpu": (ValueError, "takes CUDA tensors, not cpu"),
    "2d": (ValueError, "1-D node coordinates"),
    "too_many": (ValueError, "span more elements"),
    "zero_patch": (ValueError, "positive int node counts"),
    "float_patch": (ValueError, "positive int node counts"),
    "strided": (ValueError, "contiguous"),
    "force": (ValueError, "body force 'gravity'"),
    "callable_force": (ValueError, "body force <function"),
}


@pytest.mark.parametrize("kind", list(BAD))
def test_wrapper_checks(kind):
    args, kw = _bad(kind)
    exc, match = BAD[kind]
    with pytest.raises(exc, match=match):
        assembly.q1_assemble(*args, **kw)


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process (an in-process store)."""
    import torch.distributed as dist

    dev, created = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    assert created
    yield pmesh.ProcessMesh.create(device=dev)
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cpu_dispatch_is_the_serial_assembly(world_of_one, dtype):
    """On CPU tensors the -dist route runs the plain version: no kernel
    launch, and in a world of one the serial KKT system bit for bit."""
    from saddle_point_petsc_tpu_torch.models import saddle

    monitor.reset_counters()
    K, (f, g), mask = pdist.assemble_saddle_dist(pdist.DistGrid.create(20, 13, world_of_one), dtype=dtype,
                                                 body_force="trig")
    assert not any(k.startswith("FE") for k in monitor.counters)
    serial = saddle.assemble_saddle(20, 13, dtype=dtype, device="cpu", body_force="trig")
    assert torch.equal(K.A.planes, serial.K.A.planes) and torch.equal(f, serial.f)
    assert torch.equal(K.Bf, serial.K.Bf) and torch.equal(g, serial.g)
    assert torch.equal(mask, serial.bc_mask)
