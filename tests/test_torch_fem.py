"""Port parity: saddle_point_petsc_tpu_torch.models.fem against the JAX
package's models.fem, in float64 on the CPU.

Tolerance: max|port - ref| <= 1e-13 * max|ref|. Both packages evaluate the
same formulas; contraction order and jnp.linspace vs torch.linspace may
differ by an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import fem as jfem
from saddle_point_petsc_tpu_torch.models import fem as tfem

torch.set_num_threads(1)

GRIDS = [(5, 4), (9, 9)]  # (nex, ney) elements
REL = 1e-13


def _close(got, ref, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


def _perturbed_corners(nex, ney, seed):
    """Corner coords of a uniform grid moved by up to 10% of a cell, made
    by numpy so both packages get the same distorted elements."""
    rng = np.random.default_rng(seed)
    el = np.asarray(jfem.element_corner_coords(jfem.uniform_node_coords(nex, ney)))
    h = 1.0 / max(nex, ney)
    return el + 0.1 * h * rng.uniform(-1.0, 1.0, el.shape)


def test_quadrature_and_shape_functions():
    xi_j, w_j = jfem.gauss_quadrature_q1()
    xi_t, w_t = tfem.gauss_quadrature_q1(torch.float64)
    _close(xi_t, xi_j)
    _close(w_t, w_j)
    pts = np.random.default_rng(0).uniform(-1.0, 1.0, (7, 2))
    _close(tfem.shape_q1(torch.tensor(pts)), jfem.shape_q1(jnp.asarray(pts)))
    _close(tfem.grad_shape_q1(torch.tensor(pts)), jfem.grad_shape_q1(jnp.asarray(pts)))


@pytest.mark.parametrize("nex,ney", GRIDS)
def test_coords_and_corners(nex, ney):
    cj = jfem.uniform_node_coords(nex, ney)
    ct = tfem.uniform_node_coords(nex, ney, dtype=torch.float64)
    _close(ct, cj)
    _close(tfem.element_corner_coords(ct), jfem.element_corner_coords(cj))


@pytest.mark.parametrize("nex,ney", GRIDS)
def test_batched_element_matrices(nex, ney):
    coords = np.asarray(jfem.uniform_node_coords(nex, ney))
    ref = jfem.batched_element_matrices(jnp.asarray(coords), nex, ney)
    got = tfem.batched_element_matrices(torch.tensor(coords), nex, ney)
    _close(got, ref)


@pytest.mark.parametrize("nex,ney", GRIDS)
def test_element_stiffness_distorted(nex, ney):
    el = _perturbed_corners(nex, ney, seed=nex * 100 + ney)
    coeff = np.random.default_rng(1).uniform(0.5, 2.0, 4)
    _close(
        tfem.element_stiffness(torch.tensor(el), torch.tensor(coeff)),
        jfem.element_stiffness(jnp.asarray(el), jnp.asarray(coeff)),
    )
    gj, dj = jfem.grad_shape_physical(
        jfem.grad_shape_q1(jfem.gauss_quadrature_q1()[0]), jnp.asarray(el)[..., None, :, :]
    )
    gt, dt = tfem.grad_shape_physical(
        tfem.grad_shape_q1(tfem.gauss_quadrature_q1()[0]), torch.tensor(el)[..., None, :, :]
    )
    _close(gt, gj)
    _close(dt, dj)


@pytest.mark.parametrize("nex,ney", GRIDS)
@pytest.mark.parametrize("force", ["constant", "trig"])
def test_element_rhs(nex, ney, force):
    el = _perturbed_corners(nex, ney, seed=7)
    _close(
        tfem.element_rhs(torch.tensor(el), tfem.BODY_FORCES[force]),
        jfem.element_rhs(jnp.asarray(el), jfem.BODY_FORCES[force]),
    )


def test_batched_element_matrices_rejects_wrong_grid():
    coords = tfem.uniform_node_coords(4, 3)
    with pytest.raises(ValueError):
        tfem.batched_element_matrices(coords, 3, 4)
