"""The check catches a broken timed path: with each fault that a cell can
have planted in the program underneath a tiny CPU run, `correct` comes out
false; so does the program solving to rtol 1e-6 where its configuration
states 1e-8. (No cell has a batch, so "half of the batch left out" has no
counterpart; the exchange between chips exists only in a four-card cell.)"""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
from kkt_tiny import GRIDS, ROOT, bench, last_json, tiny_root, with_four_card

CELLS = with_four_card(bench())["workloads"]
CASES = [(w["name"], f) for w in CELLS for f in ("unchanged", "altered", "control:rtol_1e-6")]
CASES += [(w["name"], "no_exchange") for w in CELLS if w["chips"] > 1]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(tmp_path, workload, fault):
    # a looser rtol shows at 65^2 nodes (true residual 8e-7 over the limit
    # 3e-7 at rtol 1e-6), not at 17^2, where MG overshoots it to 7e-8
    root = tiny_root(tmp_path, {"kkt2241_mg": 65} if fault.startswith("control:") else GRIDS)
    argv = ["--workload", workload, "--seed", "977", "--seconds", "0.3", "--trace", "0", "--root", str(root),
            "--platform", "cpu"]
    out = subprocess.run([sys.executable, str(ROOT / "kktbench/tests/kkt_fault_rank.py"), *argv],
                         env={**os.environ, "KKT_FAULT": fault}, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = last_json(out.stdout)
    assert line["correct"] is False, line["checks"]
