"""The benchmark's 5-point Laplacian problem (kktbench/problems/poisson5.py)
and its plain reference (kktbench/reference/poisson5.py), on the CPU in a
world of one over gloo:

- the problem's DistAIJ is the kron-sum 5-point matrix, entry for entry,
  whatever the split of its rows over the ranks;
- the closed-form reference equals a direct sparse solve;
- KSP CG with the streaming gamg set-up, driven through the problem file
  with the configuration's own options, meets the reference's limits, and
  the configuration's `rtol_1e-4` control does not, nor does the exact
  answer rounded to a precision below the configuration's float32;
- the problem's assembly is one `MatAssembly` span, outside `PCSetUp`;
- neither file imports jax or the JAX package, and the reference imports
  nothing of the port either.
"""
import json
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from kktbench import cells  # noqa: E402
from kktbench import loads as L  # noqa: E402
from kktbench.reference import poisson5 as ref  # noqa: E402
from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP  # noqa: E402
from saddle_point_petsc_tpu_torch.utils.options import Options  # noqa: E402

torch.set_num_threads(1)

P = cells.load_module("problems", "poisson5")
CONFIG = json.loads((REPO / "kktbench/configs/poisson1024_gamg.json").read_text())
TRAFFIC = json.loads((REPO / "kktbench/traffic/system.json").read_text())
SEED = 2**31 + 17


def kron_5_point(m):
    """The 5-point Laplacian of an m x m interior grid as the kron sum of
    the 1-D second difference: 4 on the diagonal, -1 at each neighbour."""
    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    return (sps.kron(sps.identity(m), t) + sps.kron(t, sps.identity(m))).tocsr()


@pytest.fixture
def mesh():
    import torch.distributed as dist

    dev, created = pmesh.init_from_env(torch.device("cpu"), timeout=timedelta(seconds=60))
    assert created
    yield pmesh.ProcessMesh.create(device=dev)
    dist.destroy_process_group()


def test_problem_matrix_is_the_kron_sum(mesh):
    A = P.assemble(34, mesh, torch.float64)
    got = A.to_scipy_rows()[: 32 * 32, : 32 * 32]
    want = kron_5_point(32)
    assert A.shape == (1024, 1024) and A.dia_data is not None
    assert got.nnz == want.nnz == 5 * 32 * 32 - 4 * 32
    assert (got != want).nnz == 0


@pytest.mark.parametrize("ranks", [1, 3, 4, 7])
def test_rows_of_every_split_make_the_matrix(ranks):
    """Each rank's block of rows, as `assemble` builds it for a rank, stacks
    to the whole matrix."""
    m = 13
    n_loc = -(-(m * m) // ranks)
    blocks = [P.rows(m, min(r * n_loc, m * m), min((r + 1) * n_loc, m * m)) for r in range(ranks)]
    assert (sps.vstack(blocks).tocsr() != kron_5_point(m)).nnz == 0


@pytest.mark.parametrize("n", [34, 66])
def test_reference_matches_a_direct_solve(n):
    rng = np.random.default_rng(n)
    a = torch.tensor(rng.choice((-1.0, 1.0), size=(8, 8)))
    R = ref.Reference(n)
    f = R.field(a)
    u = spla.spsolve(kron_5_point(n - 2).tocsc(), f[1:-1, 1:-1].reshape(-1).numpy())
    star = R.exact(a)[1:-1, 1:-1].reshape(-1).numpy()
    assert np.linalg.norm(u - star) <= 1e-12 * np.linalg.norm(star)
    # the reference's own operator maps u* back to f, and reads it exact
    assert torch.linalg.vector_norm(R.apply(R.exact(a)) - f) <= 1e-12 * torch.linalg.vector_norm(f)
    nums = R.numbers(R.exact(a), a)
    assert nums["err"] == 0.0 and nums["resid_smooth"] <= 1e-13


def test_reference_field_is_the_harness_load():
    """The reference makes the load from its amplitudes as the harness's
    generator does, so the check compares against the load solved."""
    n = 34
    loads = L.Loads(TRAFFIC, n, SEED)
    a = torch.tensor(L.amplitudes(SEED, (0, 5), 1, loads.modes)[0])
    f = loads.field((0, 5), 1, (0, 0), (n, n), torch.float64, torch.device("cpu"))[0]
    assert torch.allclose(ref.Reference(n).field(a), f, rtol=0.0, atol=1e-13)


def _solve(mesh, n, dtype, options, key):
    loads = L.Loads(TRAFFIC, n, SEED)
    K = P.assemble(n, mesh, dtype)
    ksp = KSP(Options(options)).set_operators(K).set_from_options().set_up()
    b = P.rhs(loads, key, K, dtype, mesh.device)
    res = ksp.solve(b)
    (u,) = P.answer(res)
    assert u.shape == (1, n, n) and u.dtype == dtype
    assert torch.all(u[0, 0] == 0) and torch.all(u[0, :, -1] == 0)
    return res, P.Check(n, mesh.device).numbers(u, loads, key)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_stream_gamg_meets_the_limits(mesh, dtype):
    for k in range(3):
        res, nums = _solve(mesh, 66, dtype, CONFIG["options"], (0, k))
        assert res.converged_reason > 0 and res.iterations <= 10
        for name, value in nums.items():
            assert value <= CONFIG["limits"][name], (name, value)


def test_rtol_control_exceeds_the_err_limit(mesh):
    """The stated rtol broken a hundredfold: CG stops at 1e-4, and the
    answers' error reads above the limit. At 514^2 nodes, where the looser
    solve's error has grown towards what it reads at the cell's size
    (6e-5-9e-5 here, 4.7e-5-6.2e-5 at 1026^2 on the card)."""
    options = CONFIG["controls"]["rtol_1e-4"]["options"]
    for k in range(2):
        res, nums = _solve(mesh, 514, torch.float32, options, (0, k))
        assert res.converged_reason > 0
        assert nums["err"] > CONFIG["limits"]["err"], nums


@pytest.mark.parametrize("n", [66, 1026])
@pytest.mark.parametrize("low", [torch.float16, torch.bfloat16])
def test_precision_control_exceeds_the_err_limit(n, low):
    """The reference's exact answer rounded to a precision below float32
    reads an `err` above its limit: the limit tells a float32 answer from
    one that kept only half precision's digits."""
    loads = L.Loads(TRAFFIC, n, SEED)
    check = P.Check(n, torch.device("cpu"))
    for k in range(3):
        a = torch.tensor(L.amplitudes(SEED, (0, k), 1, loads.modes)[0])
        u = check.ref.exact(a).to(low)[None]
        assert check.numbers(u, loads, (0, k))["err"] > CONFIG["limits"]["err"]


def test_assembly_is_one_matassembly_span(mesh):
    """`assemble` runs under one `MatAssembly`, as ex2.c's
    MatAssemblyBegin/End; the gamg set-up's own DistAIJ builds open none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        K = P.assemble(34, mesh, torch.float64)
        KSP(Options(CONFIG["options"])).set_operators(K).set_from_options().set_up()
    names = [e.name for e in prof.events() if e.name == "MatAssembly" or e.name.startswith("GAMGLevelBuild")]
    assert names.count("MatAssembly") == 1 and names[0] == "MatAssembly"
    assert names.count("GAMGLevelBuild L0") == 1


def test_files_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "import kktbench.reference.poisson5\n"
        "assert not [m for m in sys.modules if m.split('.')[0].startswith('saddle_point_petsc_tpu')], 'port'\n"
        "from kktbench import cells\n"
        "cells.load_module('problems', 'poisson5')\n"
        "bad = sorted({{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'saddle_point_petsc_tpu'}})\n"
        "assert not bad, bad\n"
    ).format(root=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
