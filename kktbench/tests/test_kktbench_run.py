"""Tiny CPU runs of every cell through the harness (one process, or four
gloo ranks for a four-card cell): the last line's schema, no device
metric from the CPU, the import check, and the exits without a card or
without the program."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch
from kkt_tiny import ROOT, bench, last_json, tiny_root, with_four_card

from kktbench import cells, run

WORKLOADS = [w["name"] for w in with_four_card(bench())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_cpu_run(tmp_path, workload, trace):
    root = tiny_root(tmp_path)
    argv = ["--workload", workload, "--seed", str(2**31 + 11), "--seconds", "0.5", "--trace", str(trace),
            "--root", str(root), "--platform", "cpu"]
    out = subprocess.run([sys.executable, str(ROOT / "kktbench" / "run.py"), *argv], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = last_json(out.stdout)
    assert list(line)[-1] == "checks" and list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = cells.find(workload, root)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": cell.chips, "memory_peak_bytes": 0}
    assert "breakdown" not in line
    want = {m.name for m in cell.reported(trace) if m.source != "device_trace"}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    err = out.stderr.strip().splitlines()
    assert [e.split()[1] for e in err[-len(line["checks"]):]] == list(line["checks"])
    for k, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_banned_modules_compare_whole_names(monkeypatch):
    for name in ("saddle_point_petsc_tpu_torch.solvers", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.banned_modules() == []
    for name, top in (("saddle_point_petsc_tpu.models", "saddle_point_petsc_tpu"), ("jaxlib", "jaxlib"),
                      ("jax.numpy", "jax"), ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in run.banned_modules()


def test_loading_jax_fails_the_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", sys)
    argv = ["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "0.2", "--trace", "0", "--root",
            str(tiny_root(tmp_path))]
    assert run.main(argv, platform="cpu") != 0
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "kktbench" / "run.py"), "--workload", "kkt2241_mg.rhs", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kktbench", tmp_path / "kktbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "kktbench/run.py", "--workload", WORKLOADS[0], "--seed", "1", "--seconds",
                          "1", "--trace", "0", "--platform", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["command"][1] == "kktbench/run.py"
