"""Port parity: saddle_point_petsc_tpu_torch.utils.checkpoint against the
JAX package's utils.checkpoint, in float64 on the CPU.

Both write `.npz` files of `leaf_{i}` arrays in the same flattening order
(PoissonProblem: planes, f, bc_mask, coords; KrylovResult: x, iterations,
rnorm, rnorm0, history, converged_reason), so a file from either loads
through the other's `load_like` to the same arrays, bit for bit.

The JAX package is imported inside the tests that compare with it, so
that the card's test (marked gpu) also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.solvers import krylov as tk
from saddle_point_petsc_tpu_torch.solvers.krylov import KrylovResult
from saddle_point_petsc_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def _pair(n):
    from saddle_point_petsc_tpu.models import poisson as jpoisson

    jp = jpoisson.assemble_poisson(n - 1, n - 1, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    return jp, tp


def _same_problem(got, ref):
    for a, b in ((got.A.planes, ref.A.planes), (got.f, ref.f), (got.bc_mask, ref.bc_mask),
                 (got.coords, ref.coords)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _same_result(got, ref):
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.converged_reason) == int(ref.converged_reason)
    assert float(got.rnorm) == float(ref.rnorm) and float(got.rnorm0) == float(ref.rnorm0)
    for a, b in ((got.x, ref.x), (got.history, ref.history)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_poisson_problem_roundtrip(tmp_path):
    _, tp = _pair(5)
    p = checkpoint.save_pytree(tmp_path / "prob.npz", tp)
    back = checkpoint.load_like(p, tp)
    _same_problem(back, tp)
    assert back.bc_mask.dtype == torch.bool and back.A.planes.dtype == torch.float64
    leaves, structure = checkpoint.tree_flatten(tp)
    assert len(leaves) == 4 and structure.startswith("PoissonProblem(A=StencilOperator(planes=*)")
    with pytest.raises(ValueError, match="4 leaves saved"):
        checkpoint.load_like(p, (tp.f, tp.f))


def test_warm_restart_reduces_iterations(tmp_path):
    _, tp = _pair(17)
    partial = tk.cg(tp.A, tp.f, rtol=1e-4, maxiter=500)
    p = checkpoint.save_solver_state(tmp_path / "state.npz", partial, meta={"rtol": 1e-4})
    assert (tmp_path / "state.npz.meta.json").exists()
    back = checkpoint.load_like(p, partial)
    _same_result(back, partial)
    assert isinstance(back.iterations, int) and isinstance(back.rnorm, float)
    resumed = checkpoint.resume_solve(tk.cg, tp.A, tp.f, p, partial, rtol=1e-10, maxiter=500)
    cold = tk.cg(tp.A, tp.f, rtol=1e-10, maxiter=500)
    assert resumed.reason_name() == "CONVERGED_RTOL"
    assert resumed.iterations < cold.iterations


def test_files_cross_between_packages(tmp_path):
    """A PoissonProblem and a CG KrylovResult written by the JAX package's
    save_pytree load through the port's load_like to the same arrays, and
    the port's files through the JAX load_like."""
    from saddle_point_petsc_tpu.solvers import krylov as jk
    from saddle_point_petsc_tpu.utils import checkpoint as jcheckpoint

    jp, tp = _pair(9)
    rj = jk.cg(jp.A, jp.f, rtol=1e-8, maxiter=50)
    rt = tk.cg(tp.A, tp.f, rtol=1e-8, maxiter=50)
    assert rt.iterations == int(rj.iterations)

    jcheckpoint.save_pytree(tmp_path / "jprob.npz", jp)
    jcheckpoint.save_pytree(tmp_path / "jres.npz", rj)
    _same_problem(checkpoint.load_like(tmp_path / "jprob.npz", tp), jp)
    _same_result(checkpoint.load_like(tmp_path / "jres.npz", rt), rj)

    checkpoint.save_pytree(tmp_path / "tprob.npz", tp)
    checkpoint.save_pytree(tmp_path / "tres.npz", rt)
    _same_problem(jcheckpoint.load_like(tmp_path / "tprob.npz", jp), tp)
    _same_result(jcheckpoint.load_like(tmp_path / "tres.npz", rj), rt)
    assert np.array_equal(np.asarray(checkpoint.load_leaves(tmp_path / "tres.npz")[0]), rt.x.numpy())


def test_tuples_scalars_and_structure(tmp_path):
    """A KKT-shaped result: x a (u, lam) tuple, a string and None kept from
    the template, the int64 dtype of an index tensor kept."""
    from saddle_point_petsc_tpu.utils import checkpoint as jcheckpoint

    u, lam = torch.arange(6, dtype=torch.float64).reshape(2, 3), torch.tensor([0.5, -1.5])
    tree = (KrylovResult((u, lam), 7, 1e-9, 2.0, torch.ones(8, dtype=torch.float64), 2),
            "label", None, torch.arange(4))
    p = checkpoint.save_pytree(tmp_path / "kkt.npz", tree)
    with np.load(p) as z:
        assert sorted(z.files) == ["__treedef__"] + [f"leaf_{i}" for i in range(8)]
    back = checkpoint.load_like(p, tree)
    assert back[1:3] == ("label", None) and back[3].dtype == torch.int64
    assert torch.equal(back[0].x[0], u) and torch.equal(back[0].x[1], lam)
    assert back[0].iterations == 7 and back[0].rnorm == 1e-9
    assert int(jcheckpoint.load_leaves(p)[2]) == 7  # the JAX loader reads the same leaves (u, lam, its, ...)


@pytest.mark.gpu
def test_cuda_result_saves_through_host(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob = tpoisson.assemble_poisson(16, 16, dtype=torch.float64, device="cuda")
    res = tk.cg(prob.A, prob.f, rtol=1e-4, maxiter=500)
    p = checkpoint.save_solver_state(tmp_path / "cuda.npz", res)
    back = checkpoint.load_like(p, res)
    assert back.x.is_cuda and torch.equal(back.x, res.x) and back.iterations == res.iterations
    resumed = checkpoint.resume_solve(tk.cg, prob.A, prob.f, p, res, rtol=1e-10, maxiter=500)
    cold = tk.cg(prob.A, prob.f, rtol=1e-10, maxiter=500)
    assert resumed.x.is_cuda and resumed.iterations < cold.iterations
