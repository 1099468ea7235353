"""Port parity: the twins of the JAX repository's benchmark scripts
(saddle_point_petsc_tpu_torch/benchmarks/run_configs.py and scaling.py)
and the bench twin's command, on the CPU.

- `run_configs.config1` and `config2` (64^2 elements, float64) against
  the JAX benchmarks/run_configs.py: equal iterations, both relative
  residuals at most 1e-8 and equal to 1e-10 (configs 3, 3mg and 3bsr:
  test_torch_bench_config3.py).
- The scaling harness in a gloo world of 2 ranks at 33^2 (as the bench
  runs it, under torch.distributed.run): the JAX `measure`'s keys (read
  from its source) plus the port's `scaling_backend`,
  `scaling_matvec_max_err` and `scaling_device`, and the 2-rank float64 product
  equal to the serial one to 1e-12.
- `python -m saddle_point_petsc_tpu_torch.bench` with BENCH_CPU=1 and
  every size small: exit 0, a last line of JSON of at most 1900 bytes with
  no errors key and every section's keys, the full dict where
  BENCH_FULL_PATH says, nothing under benchmarks/ changed; without
  BENCH_CPU on a machine with no card it raises and prints no line; when
  BENCH_DEADLINE_S fires it prints the partial line and exits 3.
"""
import ast
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from saddle_point_petsc_tpu_torch import bench
from saddle_point_petsc_tpu_torch.benchmarks import run_configs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = {"BENCH_N": "17", "BENCH_REPS": "5", "BENCH_KKT_SOLVE_N": "17", "BENCH_KKT_N": "17",
        "BENCH_KKT_DIST_N": "17", "BENCH_AIJ_N": "16", "BENCH_AIJ_REPS": "5", "BENCH_GAMG_N": "33",
        "BENCH_C4_N": "17", "BENCH_C3_N": "16", "BENCH_C2_N": "16", "BENCH_C3BSR_N": "17",
        "BENCH_SCALING_N": "17", "BENCH_SCALING_REPS": "2", "BENCH_SCALING_RANKS": "2", "BENCH_C5_N": "17",
        "BENCH_SPMM_N": "16", "BENCH_SPMM_K": "2", "BENCH_SPMM_REPS": "2", "BENCH_SPMM_AIJ_N": "16",
        "BENCH_COPY_MIB": "4", "BENCH_DEADLINE_S": "500"}
# one key of each section of the line
SECTION_KEYS = ("spmv_pallas_nnz_per_s", "kkt_solve_s", "kkt_rtol1e8_s", "kkt_rtol1e8_dist_s", "aij_tpu_nnz_per_s",
                "gamg_its", "config2_rtol1e8_s", "config3_iterations", "config4_iterations", "config3_rtol1e8_s",
                "scaling_efficiency", "config5_s", "spmm_nnz_per_s")


def _jax_run_configs():
    spec = importlib.util.spec_from_file_location("jax_run_configs", ROOT / "benchmarks" / "run_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["config1", "config2"])
def test_run_config_matches_jax(name):
    """Config 2 (GMRES): equal counts, relative residuals equal to 1e-10.
    Config 1 (MINRES on the KKT system) ends in a plateau of MINRES's
    residual estimate, where roundoff grows about tenfold an iteration and
    the two packages' histories differ by tens of percent (ROADMAP C, the
    MINRES histories entry; tests/test_torch_saddle.py): at 64^2 the JAX
    estimate is 1.44e-8 at iteration 81 where the port's is 8.95e-9, so
    the counts may differ by one (81 and 82)."""
    mine = getattr(run_configs, name)(device=CPU)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        getattr(_jax_run_configs(), name)()
    theirs = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert mine["config"] == theirs["config"]
    assert mine["rel_rnorm"] <= 1e-8 and theirs["rel_rnorm"] <= 1e-8
    if name == "config1":
        assert abs(mine["iterations"] - theirs["iterations"]) <= 1
    else:
        assert mine["iterations"] == theirs["iterations"]
        assert abs(mine["rel_rnorm"] - theirs["rel_rnorm"]) <= 1e-10


def _jax_scaling_keys():
    """The string keys of the dicts the JAX measure and measure_aij return
    (benchmarks/scaling.py:183-206, 283-288), read from the source: running
    it compiles shard_map programs on eight fake devices."""
    tree = ast.parse((ROOT / "benchmarks" / "scaling.py").read_text())
    keys = set()
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in ("measure", "measure_aij")):
        for node in ast.walk(fn):
            returned = isinstance(node, ast.Return) or (
                isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] == ["out"])
            if returned and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
    return keys


def test_scaling_world_of_two_has_the_jax_keys():
    out = bench.bench_scaling_subprocess(n_nodes=33, reps=2, ranks=2, timeout=240)
    assert "scaling_error" not in out, out.get("scaling_error")
    assert set(out) == _jax_scaling_keys() | {"scaling_backend", "scaling_matvec_max_err", "scaling_device"}
    assert out["scaling_backend"] == "gloo-cpu" and out["scaling_devices"] == 2
    assert out["scaling_matvec_max_err"] <= 1e-12
    assert out["scaling_eff_rounds"] >= 1 and out["scaling_nnz_per_s_1dev"] > 0


def _status(path):
    return subprocess.run(["git", "status", "--porcelain", path], cwd=ROOT, capture_output=True, text=True,
                          check=True).stdout


def test_main_on_the_cpu_at_small_sizes(tmp_path):
    before = _status("benchmarks/")
    env = dict(os.environ, BENCH_CPU="1", BENCH_FULL_PATH=str(tmp_path / "full.json"), **TINY)
    run = subprocess.run([sys.executable, "-m", "saddle_point_petsc_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=400)
    assert run.returncode == 0, run.stderr[-2000:]
    line = run.stdout.strip().splitlines()[-1]
    compact = json.loads(line)
    full = json.loads((tmp_path / "full.json").read_text())
    assert len(line.encode()) <= 1900
    assert "errors" not in compact and not [k for k in full if k.endswith("_error")]
    assert [k for k in SECTION_KEYS if k not in full] == []
    assert compact["metric"] == "spmv_nnz_per_s" and full["device"].startswith("cpu")
    assert full["kkt_rtol1e8_rel_rnorm"] <= 1e-8 and full["config5_rel_rnorm"] <= 1e-8
    assert _status("benchmarks/") == before


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "BENCH_CPU"}
    run = subprocess.run([sys.executable, "-m", "saddle_point_petsc_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout.strip() == ""
    assert "no CUDA device" in run.stderr


def test_main_deadline_prints_the_partial_line(tmp_path):
    """BENCH_DEADLINE_S fires in the middle of the run: the sections measured
    so far as the line, with bench_deadline_hit_s and a zero headline, and
    exit 3."""
    env = dict(os.environ, BENCH_CPU="1", BENCH_FULL_PATH=str(tmp_path / "full.json"),
               **{**TINY, "BENCH_DEADLINE_S": "3"})
    run = subprocess.run([sys.executable, "-m", "saddle_point_petsc_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=400)
    assert run.returncode == 3, run.stderr[-2000:]
    compact = json.loads(run.stdout.strip().splitlines()[-1])
    assert compact["bench_deadline_hit_s"] == 3
    assert list(compact)[-len(bench._HEADLINE):] == [k for k in bench._KEY_ORDER if k in bench._HEADLINE]
    assert "spmm_nnz_per_s" not in compact
