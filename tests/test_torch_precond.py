"""Port parity: the preconditioners of saddle_point_petsc_tpu_torch.solvers.
precond that came with geometric multigrid (point-block Jacobi, red-black
SOR, block Jacobi, fieldsplit on the stencil, KSPInnerPC, estimate_lmax)
and their make_pc wiring, against the JAX package, in float64 on the CPU.

Tolerances: every apply to rtol = atol = 1e-12 of the reference (the same
formulas; block Jacobi's dense products sum 2113 terms in another order);
the block inverses bit-equal (both invert the same numpy blocks with
numpy). estimate_lmax draws its start vector in a function of its own,
which the tests replace by the JAX draw (PRNGKey(0)); with the same start
the 10-step power iteration agrees to 1e-12 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.ops import sparse as jsp
from saddle_point_petsc_tpu.solvers import precond as jpc
from saddle_point_petsc_tpu.solvers.ksp import make_pc as jmake_pc
from saddle_point_petsc_tpu.utils.options import Options as JOptions
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.ops import sparse as tsp
from saddle_point_petsc_tpu_torch.ops.cuda import rng
from saddle_point_petsc_tpu_torch.parallel.mesh import ProcessMesh
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.solvers.ksp import make_pc as tmake_pc
from saddle_point_petsc_tpu_torch.utils.options import Options

torch.set_num_threads(1)


def jax_draw(template, generator):
    """The JAX package's start vector (normal draws from PRNGKey(0), the
    same key for every leaf), as the port's tensors."""

    def draw(a):
        v = jax.random.normal(jax.random.PRNGKey(0), tuple(a.shape), jnp.float64)
        return torch.tensor(np.asarray(v), dtype=a.dtype)

    return tuple(draw(a) for a in template) if isinstance(template, tuple) else draw(template)


@pytest.fixture
def jax_start(monkeypatch):
    monkeypatch.setattr(tpc, "_start_vector", jax_draw)


def _pair(n):
    jp = jpoisson.assemble_poisson(n - 1, n - 1, body_force="trig")
    tp = tpoisson.poisson_problem_from_numpy(
        *(np.asarray(a) for a in (jp.A.planes, jp.f, jp.bc_mask, jp.coords)), device="cpu"
    )
    return jp, tp


@pytest.fixture(scope="module")
def p17():
    return _pair(17)


@pytest.fixture(scope="module")
def csr_pair():
    """The 9 x 8-node Poisson CSR in both packages (144 rows)."""
    return jpoisson.assemble_poisson_csr(8, 7)[0], tpoisson.assemble_poisson_csr(8, 7, device="cpu")[0]


def _close(got, ref):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=1e-12, atol=1e-12 * np.max(np.abs(np.asarray(ref)))
    )


def _field(n, seed):
    return np.random.default_rng(seed).standard_normal((2, n, n))


def test_pbjacobi_apply(p17):
    jp, tp = p17
    Mj, Mt = jpc.pbjacobi(jp.A), tpc.pbjacobi(tp.A)
    _close(Mt.inv_blocks, Mj.inv_blocks)
    r = _field(17, 0)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    flat = r.transpose(1, 2, 0).reshape(-1)  # natural interleaved ordering
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))


def test_pbjacobi_bsr(csr_pair):
    csr_j, csr_t = csr_pair
    Mj = jpc.pbjacobi(jsp.csr_to_bsr(jsp.csr_compact(csr_j), 2))
    Mt = tpc.pbjacobi(tsp.csr_to_bsr(csr_t, 2))
    r = np.random.default_rng(1).standard_normal(csr_t.shape[0])
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    with pytest.raises(TypeError):
        tpc.pbjacobi(csr_t)


@pytest.mark.parametrize("order", ["symmetric", "forward", "backward"])
def test_sor_apply(p17, order):
    jp, tp = p17
    r = _field(17, 2)
    for omega, sweeps in ((1.0, 1), (1.3, 2)):
        Mj = jpc.sor(jp.A, omega=omega, sweeps=sweeps, order=order)
        Mt = tpc.sor(tp.A, omega=omega, sweeps=sweeps, order=order)
        _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    flat = r.transpose(1, 2, 0).reshape(-1)
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))
    with pytest.raises(ValueError):
        tpc.sor(tp.A, order="sideways")


def test_block_jacobi_stencil_apply():
    """Config 1's grid: 65^2 nodes, 8,450 rows, 4 blocks of 2113."""
    jp, tp = _pair(65)
    Mj, Mt = jpc.block_jacobi_stencil(jp.A), tpc.block_jacobi_stencil(tp.A)
    assert tuple(Mt.inv.shape) == (4, 2113, 2113) and Mt.n == 8450
    assert np.array_equal(Mt.inv.numpy(), np.asarray(Mj.inv))
    r = _field(65, 3)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_block_jacobi_csr_and_dense(csr_pair):
    csr_j, csr_t = csr_pair
    r = np.random.default_rng(4).standard_normal(csr_t.shape[0])
    for nb in (5, 7):  # 144 rows: the last block padded with identity
        Mj = jpc.block_jacobi(jsp.csr_compact(csr_j), nb)
        Mt = tpc.block_jacobi(csr_t, nb)
        _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    # 144 rows in 40 blocks of 4: the last four blocks hold padding alone
    # (the JAX function's slicing raises there); they are identity
    Mt = tpc.block_jacobi(csr_t, 40)
    assert Mt.inv.shape == (40, 4, 4) and torch.equal(Mt.inv[36:], torch.eye(4, dtype=torch.float64).expand(4, 4, 4))
    _close(Mt(torch.tensor(r)), jpc.block_jacobi(jsp.csr_compact(csr_j), 36)(jnp.asarray(r)))
    dense = tsp.csr_to_scipy(csr_t).toarray()
    Md = tpc.block_jacobi(dense, 2, max_block=50, device="cpu")  # the cap raises the count to 3
    assert Md.inv.shape[0] == 3
    _close(Md(torch.tensor(r)), jpc.block_jacobi(dense, 2, max_block=50)(jnp.asarray(r)))


@pytest.mark.parametrize("fs_type", ["additive", "multiplicative"])
def test_fieldsplit_apply(p17, fs_type):
    jp, tp = p17
    Mj, Mt = jpc.fieldsplit(jp.A, fs_type=fs_type), tpc.fieldsplit(tp.A, fs_type=fs_type)
    r = _field(17, 5)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    flat = r.transpose(1, 2, 0).reshape(-1)
    _close(Mt(torch.tensor(flat)), Mj(jnp.asarray(flat)))
    x = r[0]
    _close(Mt.A10(torch.tensor(x)), Mj.A10(jnp.asarray(x)))
    with pytest.raises(ValueError):
        tpc.fieldsplit(tp.A, fs_type="schur")


@pytest.mark.parametrize("solver", ["cg", "bcgs", "gmres"])
def test_ksp_inner_pc_apply(p17, solver):
    jp, tp = p17
    Mj = jpc.KSPInnerPC(jp.A, jpc.jacobi(jp.A), solver=solver, rtol=1e-3, maxiter=7)
    Mt = tpc.KSPInnerPC(tp.A, tpc.jacobi(tp.A), solver=solver, rtol=1e-3, maxiter=7)
    r = _field(17, 6)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))
    with pytest.raises(ValueError):
        tpc.KSPInnerPC(tp.A, None, solver="lsqr")


def test_estimate_lmax_with_the_jax_start(p17, jax_start):
    jp, tp = p17
    tmpl = np.ones((2, 17, 17))
    for Mj, Mt in ((jpc.jacobi(jp.A), tpc.jacobi(tp.A)), (None, None)):
        lj = float(jpc.estimate_lmax(jp.A, Mj, template=jnp.asarray(tmpl)))
        lt = tpc.estimate_lmax(tp.A, Mt, template=torch.tensor(tmpl))
        assert abs(lt - lj) <= 1e-12 * lj
    with pytest.raises(ValueError):
        tpc.estimate_lmax(tp.A)


def test_estimate_lmax_own_start_is_seeded(p17):
    """Without the replacement the port draws its start with the
    counter-based generator of ops/cuda/rng.py, keyed by the generator's
    seed (0 by default): reproducible, and the estimate agrees with the
    JAX one's to the spread a 10-step power iteration leaves from another
    start (measured 0.0100 relative here; 0.0067-0.0100 at 9^2 to 65^2
    nodes)."""
    jp, tp = p17
    tmpl = torch.ones((2, 17, 17), dtype=torch.float64)
    M = tpc.jacobi(tp.A)
    a = tpc.estimate_lmax(tp.A, M, template=tmpl)
    assert a == tpc.estimate_lmax(tp.A, M, template=tmpl)
    g = torch.Generator().manual_seed(7)
    assert a != tpc.estimate_lmax(tp.A, M, template=tmpl, generator=g)
    lj = float(jpc.estimate_lmax(jp.A, jpc.jacobi(jp.A), template=jnp.ones((2, 17, 17))))
    assert abs(a - lj) <= 0.02 * lj


# Random123's known-answer vectors of Philox4x32-10 (kat_vectors):
# (counter, key, output)
_PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", _PHILOX_KAT, ids=["zeros", "ones", "pi"])
def test_philox_twin_known_answers(counter, key, want):
    got = rng.philox4x32(np.array(counter, dtype=np.uint32), key)
    assert got.dtype == np.uint32 and tuple(int(w) for w in got) == want


def test_normal_draw_is_a_pure_function():
    """The draw depends on (seed, leaf, shape, dtype) alone, element k on
    (seed, leaf, k) alone: a shape or a longer draw keeps the flat values,
    f32 is the f64 draw rounded, another seed or leaf draws otherwise."""
    t = torch.empty((2, 5, 7), dtype=torch.float64)
    a = rng.normal_like(t, 3, 1)
    assert torch.equal(a, rng.normal_like(t, 3, 1))
    assert torch.equal(a.reshape(-1), rng.normal_like(torch.empty(71, dtype=torch.float64), 3, 1)[:70])
    assert torch.equal(rng.normal_like(t.float(), 3, 1), a.float())
    for seed, leaf in ((4, 1), (3, 0), (3 + (1 << 32), 1)):
        assert not torch.isclose(rng.normal_like(t, seed, leaf), a).any()
    # the counter's high word and the key: pair 2^32 + 5 of a draw
    w = rng.philox_words_plain(1, 9, 2, start=(1 << 32) + 5)
    assert np.array_equal(w, rng.philox4x32(np.array([[5, 1, 0, 0]], dtype=np.uint32), (9, 2)))
    out = torch.zeros(4, dtype=torch.float64)
    assert rng.normal_(out, 3, 1) is out and torch.equal(out, a.reshape(-1)[:4])
    for bad in (torch.zeros(4, dtype=torch.int32), torch.zeros((4, 4), dtype=torch.float64).t()):
        with pytest.raises((TypeError, ValueError)):
            rng.normal_(bad)
    for seed, leaf in ((-1, 0), (1 << 64, 0), (0, 1 << 32)):
        with pytest.raises(ValueError):
            rng.normal_like(t, seed, leaf)
    with pytest.raises(ValueError):
        rng.philox_words(4, device="cpu")


def test_start_vector_keys_leaves_and_generator():
    """_start_vector keys each leaf by its index in the tuple and the draw
    by the generator's initial seed (0 without one)."""
    t = (torch.empty((2, 4, 4), dtype=torch.float64), torch.empty(4, dtype=torch.float32))
    u, p = tpc._start_vector(t, None)
    assert torch.equal(u, rng.normal_like(t[0], 0, 0)) and torch.equal(p, rng.normal_like(t[1], 0, 1))
    assert p.dtype == torch.float32
    assert torch.equal(tpc._start_vector(t[0], torch.Generator().manual_seed(7)), rng.normal_like(t[0], 7))


def test_patch_of_global_draw_is_serial_slice():
    """A rank's patch (or block of rows) of the draw on its global template
    equals the same slice of the serial draw, and the global templates hold
    no memory of their size."""
    serial = rng.normal_like(torch.empty((2, 12, 10), dtype=torch.float64))
    rows = rng.normal_like(torch.empty((4, 3), dtype=torch.float64))
    for pj, pi in ((0, 0), (1, 1), (2, 0)):
        m = ProcessMesh(3, 2, pj, pi, torch.device("cpu"))
        g = m.global_like(torch.empty((2, 4, 5), dtype=torch.float64))
        assert g.shape == (2, 12, 10) and g.untyped_storage().nbytes() == 8
        patch = m.local_patch(tpc._start_vector(g, None))
        assert torch.equal(patch, serial[:, 4 * pj : 4 * pj + 4, 5 * pi : 5 * pi + 5])
    m = ProcessMesh(1, 4, 0, 2, torch.device("cpu"))
    g = m.global_rows_like(torch.empty((1, 3), dtype=torch.float64))
    assert g.shape == (4, 3) and torch.equal(m.local_rows(tpc._start_vector(g, None)), rows[2:3])


def test_normal_draw_moments():
    """10^6 draws: sample mean and variance within 5 sigma of 0 and 1."""
    n = 10**6
    z = rng.normal_plain(n, seed=12345)
    assert abs(z.mean()) <= 5 / np.sqrt(n)
    assert abs(z.var() - 1.0) <= 5 * np.sqrt(2.0 / n)
    u1, u2 = rng._uniforms(rng.philox_words_plain(1000))
    assert 0 < u1.min() and u1.max() <= 1 and 0 <= u2.min() and u2.max() < 1

_PC_OPTIONS = [
    ("pbjacobi", []),
    ("sor", ["-pc_sor_omega", "1.2", "-pc_sor_its", "2"]),
    ("bjacobi", ["-pc_bjacobi_blocks", "3"]),
    ("chebyshev", ["-pc_chebyshev_its", "4"]),
    ("chebyshev", ["-pc_chebyshev_esteig"]),
    ("fieldsplit", ["-pc_fieldsplit_type", "multiplicative"]),
]


@pytest.mark.parametrize("pc_type,opts", _PC_OPTIONS)
def test_make_pc_matches_jax(p17, jax_start, pc_type, opts):
    jp, tp = p17
    Mj = jmake_pc(pc_type, jp.A, JOptions(opts))
    Mt = tmake_pc(pc_type, tp.A, Options(opts))
    assert type(Mt).__name__ == type(Mj).__name__
    r = _field(17, 7)
    _close(Mt(torch.tensor(r)), Mj(jnp.asarray(r)))


def test_make_pc_refuses(p17, csr_pair):
    _, tp = p17
    csr = csr_pair[1]
    for pc_type in ("sor", "fieldsplit", "mg"):
        with pytest.raises(ValueError):
            tmake_pc(pc_type, csr)
    dia, _ = tsp.csr_to_dia(csr)
    with pytest.raises(ValueError):
        tmake_pc("bjacobi", dia)
    with pytest.raises(ValueError, match="ilu PC requires stencil or CSR operator"):
        tmake_pc("ilu", dia)
