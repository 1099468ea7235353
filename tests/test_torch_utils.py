"""The port's own utility modules against the JAX package's, and the
library API's device default.

- `utils/options.py`: `parse_argv` and `Options` give the JAX module's
  dicts and typed values exactly (both are pure Python).
- `utils/native.py`: `rcm`, `aggregate`, `coo_to_csr`,
  `lower_solve_unit` and `upper_solve` give the JAX module's arrays
  exactly (the same C++ functions, compiled twice); the port's library is
  built under its own `csrc/_build/`.
- The library API defaults to the CUDA card: without one, every entry
  point that makes tensors raises unless it is given `device="cpu"`.
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.utils import native as jnative
from saddle_point_petsc_tpu.utils import options as joptions
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.models import saddle as tsaddle
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.csrc import BUILD_DIR
from saddle_point_petsc_tpu_torch.utils import native as tnative
from saddle_point_petsc_tpu_torch.utils import options as toptions
from saddle_point_petsc_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ARGVS = [
    [],
    ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"],
    ["-ksp_monitor", "-ksp_converged_reason", "-options_left"],  # bare flags
    ["-shift", "-1.5", "-offset", "-3", "-dot", "-.5", "-x"],  # negative values
    ["-flag", "true", "-off", "no", "-on", "1", "-zero", "0", "-yes", "YES"],
    ["stray", "-a", "1", "value", "--double", "2", "-", "-b"],  # stray tokens, '-', '--'
    ["-fieldsplit_0_pc_type", "ilu", "-fieldsplit_0_ksp_rtol", "1e-3", "-pc_type", "fieldsplit"],
    ["-vtk", "out dir/test.vtk", "-A_mat_view", "a.npz:npz", "-da_grid_x", "17"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[f"argv{i}" for i in range(len(ARGVS))])
def test_parse_argv_matches_jax(argv):
    assert toptions.parse_argv(argv) == joptions.parse_argv(argv)


def _queries(opts, names):
    """Every getter on every name, scoped and not, exceptions as values."""
    out = []
    for db in (opts, opts.scoped("fieldsplit_0_")):
        for name in names:
            for get in ("get_str", "get_int", "get_float", "get_bool", "has"):
                try:
                    out.append((get, name, getattr(db, get)(name)))
                except ValueError as e:
                    out.append((get, name, type(e).__name__))
    return out


@pytest.mark.parametrize("argv", ARGVS, ids=[f"argv{i}" for i in range(len(ARGVS))])
def test_options_match_jax(argv):
    tj, tt = joptions.Options(argv), toptions.Options(argv)
    names = sorted({k for k, _ in tj.items()} | {"pc_type", "ksp_rtol", "missing"})
    assert _queries(tt, names) == _queries(tj, names)
    assert tt.unused() == tj.unused() and repr(tt) == repr(tj)
    source = {f"-{k}": v for k, v in tj.items()} | {"none": None}
    dj, dt = joptions.Options(source), toptions.Options(source)
    dj.set("extra", 3)
    dt.set("extra", 3)
    assert sorted(dt.items()) == sorted(dj.items()) and dt.unused() == dj.unused()


def _poisson_pattern():
    """The off-diagonal pattern of the 33^2-node Poisson CSR (symmetric)."""
    csr = jpoisson.assemble_poisson_csr(32, 32)[0]
    n = csr.shape[0]
    indptr = np.array(csr.indptr)
    a = sps.csr_matrix(
        (np.array(csr.vals[: indptr[-1]]), np.array(csr.cols[: indptr[-1]]), indptr), shape=(n, n)
    )
    a.eliminate_zeros()
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def _random_pattern(n=500, seed=7):
    """A random symmetric graph with isolated vertices, from a numpy seed."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 4 * n)
    c = rng.integers(0, n, 4 * n)
    keep = (r != c) & (r < n - 20) & (c < n - 20)  # the last 20 vertices stay isolated
    a = sps.coo_matrix((np.ones(keep.sum()), (r[keep], c[keep])), shape=(n, n)).tocsr()
    a = (a + a.T).tocsr()
    a.sort_indices()
    return a


@pytest.mark.parametrize("graph", ["poisson33", "random"])
def test_native_matches_jax(graph):
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler for the native host libraries")
    a = _poisson_pattern() if graph == "poisson33" else _random_pattern()
    n = a.shape[0]
    np.testing.assert_array_equal(
        tnative.rcm(a.indptr, a.indices, n), jnative.rcm(a.indptr, a.indices, n)
    )
    agg_t, na_t = tnative.aggregate(a.indptr, a.indices, n)
    agg_j, na_j = jnative.aggregate(a.indptr, a.indices, n)
    assert na_t == na_j and na_t > 1
    np.testing.assert_array_equal(agg_t, agg_j)
    assert sorted(tnative.rcm(a.indptr, a.indices, n)) == list(range(n))


def test_native_coo_to_csr_matches_jax():
    """Duplicates summed, a padding row (-1) and a row past m dropped, empty
    rows kept: the JAX binding's arrays bit for bit, and scipy's CSR."""
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler for the native host libraries")
    rng = np.random.default_rng(11)
    m, nnz = 40, 300
    rows = rng.integers(0, m - 5, nnz).astype(np.int32)  # the last 5 rows stay empty
    cols = rng.integers(0, m, nnz).astype(np.int32)
    rows[:50], cols[:50] = rows[50:100], cols[50:100]  # duplicates
    rows[7], rows[8] = -1, m  # padding, and a row past the matrix
    vals = rng.standard_normal(nnz)
    got, ref = tnative.coo_to_csr(rows, cols, vals, m), jnative.coo_to_csr(rows, cols, vals, m)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g, r)
    keep = (rows >= 0) & (rows < m)
    want = sps.coo_matrix((vals[keep], (rows[keep], cols[keep])), shape=(m, m)).tocsr()
    want.sum_duplicates()
    np.testing.assert_array_equal(got[0], want.indptr)
    np.testing.assert_array_equal(got[1], want.indices)
    np.testing.assert_allclose(got[2], want.data, rtol=1e-12)
    with pytest.raises(ValueError, match="300 rows, 299 columns"):
        tnative.coo_to_csr(rows, cols[:-1], vals, m)


@pytest.mark.parametrize("graph", ["poisson33", "random"])
def test_native_triangular_solves_match_jax(graph):
    """The exact CSR triangular solves of an ILU(0) factorization: the JAX
    binding's bits, and dense solves of the unit-lower and upper factors
    to 1e-10."""
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler for the native host libraries")
    a = _poisson_pattern() if graph == "poisson33" else _random_pattern(n=200)
    n = a.shape[0]
    a = (a + sps.diags(np.asarray(abs(a).sum(axis=1)).ravel() + 1.0)).tocsr()  # diagonally dominant
    a.sort_indices()
    f = sps.csr_matrix((tnative.ilu0(a.indptr, a.indices, a.data, n), a.indices, a.indptr), shape=(n, n))
    L, U = sps.tril(f, -1).tocsr(), sps.triu(f).tocsr()
    b = np.random.default_rng(3).standard_normal(n)
    y = tnative.lower_solve_unit(L.indptr, L.indices, L.data, b)
    np.testing.assert_array_equal(y, jnative.lower_solve_unit(L.indptr, L.indices, L.data, b))
    np.testing.assert_allclose((L + sps.identity(n)) @ y, b, atol=1e-10)
    x = tnative.upper_solve(U.indptr, U.indices, U.data, y)
    np.testing.assert_array_equal(x, jnative.upper_solve(U.indptr, U.indices, U.data, y))
    np.testing.assert_allclose(U @ x, y, atol=1e-10)
    # malformed input is refused before the library reads past an array
    with pytest.raises(ValueError, match="row pointers"):
        tnative.upper_solve(U.indptr[:-1], U.indices, U.data, y)
    with pytest.raises(ValueError, match="column indices"):
        tnative.lower_solve_unit(L.indptr, L.indices + n, L.data, b)


def test_native_builds_in_port_tree():
    if not tnative.available():
        pytest.skip("no C++ compiler for the native host library")
    path = tnative._library_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert "saddle_point_petsc_tpu_torch" in path.parts


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def _numpy_saddle():
    p = tsaddle.assemble_saddle(2, 2, device="cpu")
    return tuple(t.numpy() for t in (p.A.planes, p.Bf, p.f, p.g, p.bc_mask, p.coords))


_A = sps.identity(4, format="csr")
_CALLS = {
    "assemble_poisson": lambda **kw: tpoisson.assemble_poisson(2, 2, **kw),
    "assemble_poisson_csr": lambda **kw: tpoisson.assemble_poisson_csr(2, 2, **kw),
    "assemble_saddle": lambda **kw: tsaddle.assemble_saddle(2, 2, **kw),
    "solve_saddle_point_problem": lambda **kw: tsaddle.solve_saddle_point_problem(2, 2, **kw),
    "saddle_problem_from_numpy": lambda **kw: tsaddle.saddle_problem_from_numpy(*_numpy_saddle(), **kw),
    "poisson_problem_from_numpy": lambda **kw: tpoisson.poisson_problem_from_numpy(
        *(a for i, a in enumerate(_numpy_saddle()) if i not in (1, 3)), **kw),
    "scipy_to_csr": lambda **kw: tsp.scipy_to_csr(_A, **kw),
    "csr_from_numpy": lambda **kw: tsp.csr_from_numpy(_A.indptr, _A.indices, _A.data, _A.shape, **kw),
    "dia_from_numpy": lambda **kw: tsp.dia_from_numpy(np.ones((1, 4)), (0,), (4, 4), **kw),
    "bdia_from_numpy": lambda **kw: tsp.bdia_from_numpy(np.ones((1, 2, 2, 2)), (0,), (4, 4), **kw),
}


def _devices(out):
    if isinstance(out, torch.Tensor):
        return {out.device.type}
    if isinstance(out, (tuple, list)):
        return set().union(*(_devices(o) for o in out))
    if hasattr(out, "__dataclass_fields__"):
        return set().union(*(_devices(getattr(out, f)) for f in out.__dataclass_fields__))
    return set()


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_library_api_defaults_to_card(name):
    """No device: the card, and without one a RuntimeError; device="cpu":
    tensors on the CPU only."""
    if torch.cuda.is_available():
        assert _devices(_CALLS[name]()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _CALLS[name]()
    assert _devices(_CALLS[name](device="cpu")) == {"cpu"}
