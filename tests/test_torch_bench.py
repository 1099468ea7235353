"""Port parity: the bench twin (saddle_point_petsc_tpu_torch/bench.py)
against the JAX repository's bench.py, on the CPU.

- Emission: `_sig4` and the key order against the JAX bench's own
  (imported from bench.py, whose `_emit` is never called: it writes
  benchmarks/BENCH_FULL.json), and the compact line's rules on a
  synthetic dict: `errors` first, keys dropped from the front (never
  the headline, `device` or `scaling_backend`), the headline last, at
  most 1900 bytes.
- Sections at 17^2-64^2 against the JAX functions: `bench_time_to_rtol`
  in float64 (equal iterations), `bench_refined_kkt` for both inner kinds,
  `bench_refined_kkt_bsr` (equal cycles, inner iterations within 10% or
  3, both at rtol 1e-8; the port's estimate_lmax starts from the JAX
  package's draw), `bench_refined_kkt_config2` (the same, inner
  iterations within 20%: float32 GMRES(30) follows the sums' order),
  `bench_gamg` against the JAX `dist_amg_pc(setup="stream")` on
  `make_mesh_1d(1)` (equal iterations), and the key sets of
  `bench_aij_tpu` and `bench_spmm`.

The JAX bench's refinements set jax_enable_x64 to False when they finish
(bench.py:164, 280); tests/conftest.py enables it for every test, so each
test that calls one restores it.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu.parallel import dist_csr as jdist_csr
from saddle_point_petsc_tpu.solvers import amg as jamg
from saddle_point_petsc_tpu.solvers import krylov as jk
from saddle_point_petsc_tpu_torch import bench
from saddle_point_petsc_tpu_torch.benchmarks import harness
from saddle_point_petsc_tpu_torch.solvers import precond as tpc

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    """The JAX repository's bench.py as a module."""
    return _load("jax_bench", ROOT / "bench.py")


@pytest.fixture
def x64():
    """Restore jax_enable_x64 after a JAX bench function turned it off."""
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def jax_draw(monkeypatch):
    """estimate_lmax's start vector as the JAX package draws it (PRNGKey(0)
    in the template's type)."""

    def draw(template, generator):
        def one(a):
            jdt = jnp.float32 if a.dtype == torch.float32 else jnp.float64
            return torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0), tuple(a.shape), jdt)),
                                dtype=a.dtype)

        return tuple(one(a) for a in template) if isinstance(template, tuple) else one(template)

    monkeypatch.setattr(tpc, "_start_vector", draw)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------


def test_key_order_ends_with_the_jax_bench_order(jbench):
    """The JAX keys in the JAX order, drop-first to drop-last, the port's own
    keys before them (dropped first); the same headline."""
    n = len(jbench._KEY_ORDER)
    assert bench._KEY_ORDER[-n:] == jbench._KEY_ORDER
    assert not set(bench._KEY_ORDER[:-n]) & set(jbench._KEY_ORDER)
    assert bench._HEADLINE == jbench._HEADLINE
    assert len(set(bench._KEY_ORDER)) == len(bench._KEY_ORDER)
    assert bench._KEEP <= set(bench._KEY_ORDER) and not bench._KEEP & bench._HEADLINE


@pytest.mark.parametrize("x", [1234.5678, 0.000123456, -9.87654e12, 0.0, 3, "minres", None, float("nan"),
                               float("inf"), 1e-300, 7.0])
def test_sig4_matches_the_jax_bench(jbench, x):
    assert bench._sig4(x) == jbench._sig4(x)


def _synthetic(n_extra=0):
    out = {k: 1.2345678e-3 * (i + 1) for i, k in enumerate(bench._KEY_ORDER)}
    out.update(metric="spmv_nnz_per_s", unit="nnz/s", value=3.0e10, vs_baseline=0.75, kkt_rtol1e8_s=0.25)
    out["not_in_the_order"] = 1.0
    for i in range(n_extra):
        out[f"config{i}_error"] = "boom"
    return out


def _emitted(tmp_path, monkeypatch, capsys, out, limit=1900):
    monkeypatch.setenv("BENCH_FULL_PATH", str(tmp_path / "full.json"))
    bench._emit(out, limit=limit)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return line, json.loads(line), json.loads((tmp_path / "full.json").read_text())


@pytest.mark.parametrize("limit", [1900, 600, 60])
def test_emit_compacts_from_the_front_and_keeps_the_headline_last(tmp_path, monkeypatch, capsys, limit):
    out = _synthetic(n_extra=2)
    line, compact, full = _emitted(tmp_path, monkeypatch, capsys, out, limit)
    assert full == json.loads(json.dumps(out))  # the full dict, unrounded
    keys = list(compact)
    assert keys[0] == "errors" and compact["errors"] == "config0,config1"
    headline = [k for k in bench._KEY_ORDER if k in bench._HEADLINE]
    assert keys[-len(headline):] == headline
    assert "not_in_the_order" not in compact
    kept = [k for k in bench._KEY_ORDER if k in compact]
    assert kept == keys[1:]
    assert bench._KEEP <= set(kept)  # the card and the scaling backend are never dropped
    # the other kept keys are a suffix of the order: only the front was dropped
    rest = [k for k in kept if k not in bench._KEEP]
    assert rest == [k for k in bench._KEY_ORDER if k in out and k not in bench._KEEP][-len(rest):]
    if limit >= 1900:
        assert len(line) <= limit
    else:  # the headline, _KEEP and errors stay whatever the limit
        assert set(keys) == {"errors", *bench._HEADLINE, *bench._KEEP} or len(line) <= limit
    assert all(compact[k] == bench._sig4(out[k]) for k in kept)


def test_emit_without_errors_has_no_errors_key(tmp_path, monkeypatch, capsys):
    line, compact, _ = _emitted(tmp_path, monkeypatch, capsys, _synthetic())
    assert "errors" not in compact and len(line) <= 1900
    assert list(compact)[-1] == "kkt_rtol1e8_s"


def test_the_twins_import_no_jax():
    """The bench twin and its two benchmark modules leave jax and the JAX
    package out of the process."""
    code = ("import sys\n"
            "import saddle_point_petsc_tpu_torch.bench, saddle_point_petsc_tpu_torch.benchmarks.run_configs\n"
            "import saddle_point_petsc_tpu_torch.benchmarks.scaling\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'saddle_point_petsc_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


# ---------------------------------------------------------------------------
# sections against the JAX bench
# ---------------------------------------------------------------------------


def test_time_to_rtol_matches_jax_in_f64(jbench):
    t, its, rrel = bench.bench_time_to_rtol(17, dtype=torch.float64, device=CPU)
    jt, jits, jrrel = jbench.bench_time_to_rtol(17, dtype=jnp.float64)
    assert its == jits and rrel <= 1e-8 and jrrel <= 1e-8 and t > 0


@pytest.mark.parametrize("kind", ["minres", "fgmres-mg"])
def test_refined_kkt_matches_jax(jbench, x64, jax_draw, kind):
    t, cycles, its, rrel = bench.bench_refined_kkt(17, inner_kind=kind, device=CPU)
    jt, jcycles, jits, jrrel = jbench.bench_refined_kkt(17, inner_kind=kind)
    assert cycles == jcycles
    assert abs(its - jits) <= max(3, 0.1 * jits), (its, jits)
    assert rrel <= 1e-8 and jrrel <= 1e-8 and t > 0


def test_refined_kkt_bsr_matches_jax(jbench, x64):
    """Config 3 as worded to rtol 1e-8 (the 2x2 block-DIA inner CG under
    FGMRES) at 17^2 nodes."""
    t, cycles, its, rrel = bench.bench_refined_kkt_bsr(17, device=CPU)
    jt, jcycles, jits, jrrel = jbench.bench_refined_kkt_bsr(17)
    assert cycles == jcycles
    assert abs(its - jits) <= max(3, 0.1 * jits), (its, jits)
    assert rrel <= 1e-8 and jrrel <= 1e-8 and t > 0


def test_refined_kkt_config2_matches_jax(jbench, x64):
    """Config 2 to rtol 1e-8 (GMRES(30) + Schur(full) float32 corrections)
    at the 64^2 elements the JAX function fixes: equal cycles, both at
    rtol 1e-8, inner iterations within 20%. Restarted GMRES in float32
    stagnates between restarts here, so its count follows the order of
    the float32 sums: on one input the port takes 229 inner iterations
    (per cycle 1, 103, 71, 54) with one CPU thread and 295 (1, 103, 79,
    112) with four, 4 cycles both; the JAX function takes 262. In float64
    the two GMRES agree to the iteration (test_torch_bench_configs.py,
    config 2)."""
    t, cycles, its, rrel = bench.bench_refined_kkt_config2(device=CPU)
    jt, jcycles, jits, jrrel = jbench.bench_refined_kkt_config2()
    assert cycles == jcycles
    assert abs(its - jits) <= 0.2 * jits, (its, jits)
    assert rrel <= 1e-8 and jrrel <= 1e-8 and t > 0


def test_gamg_matches_jax_stream_setup():
    """The port's bench_gamg (a world of one) and the JAX streaming gamg on
    a one-device 1-D mesh: the same CG count on the 40^2 5-point operator."""
    n = 40
    out = bench.bench_gamg(n, device=CPU)
    a = harness.poisson5(n)
    mesh = jdist_csr.make_mesh_1d(1)
    A = jdist_csr.dist_aij_from_scipy(a, mesh)
    b = jdist_csr.pad_vector(np.ones(a.shape[0], np.float32), A.n_pad, mesh)
    res = jk.cg(A, b, M=jamg.dist_amg_pc(A, setup="stream"), rtol=1e-6, maxiter=100)
    assert out["gamg_its"] == int(res.iterations) and out["gamg_reason"] == int(res.converged_reason)
    assert out["gamg_rows"] == n * n and out["gamg_setup_s"] > 0 and out["gamg_solve_s"] > 0


def test_aij_tpu_keys_match_jax(jbench):
    mine = bench.bench_aij_tpu(16, reps=2, device=CPU)
    theirs = jbench.bench_aij_tpu(16, reps=2)
    assert set(mine) == set(theirs)
    assert mine["aij_tpu_distaij_format"] == theirs["aij_tpu_distaij_format"] == "dia+ell"
    assert mine["aij_tpu_rows"] == theirs["aij_tpu_rows"] and mine["aij_tpu_nnz"] == theirs["aij_tpu_nnz"]
    assert all(mine[k] > 0 for k in mine if k.endswith("_per_s"))


def test_spmm_keys_match_jax(jbench):
    mine = bench.bench_spmm(16, k=2, reps=2, aij_nodes=8, device=CPU)
    theirs = jbench.bench_spmm(16, k=2, reps=2, aij_nodes=8)
    assert not [k for k in theirs if k.endswith("_error")]
    assert set(mine) == set(theirs)
    assert mine["spmm_k"] == 2 and mine["spmm_stencil_pallas_n"] == theirs["spmm_stencil_pallas_n"] == 16
