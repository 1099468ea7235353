"""The controls of `correct`: each entry of a configuration's `controls`
(the nearest precision below the one it states, or its stated rtol
broken) applied to the program. At a cell's own size on the card each
must fail a limit that sound runs meet; on the CPU, at a tiny size, the
override must reach the program."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch
from kkt_tiny import ROOT, bench, last_json, tiny_root

from kktbench import cells, runner

CONTROLS = [(w["name"], c) for w in bench()["workloads"] for c in cells.find(w["name"]).config["controls"]]


@pytest.mark.parametrize("control", sorted({c for _, c in CONTROLS}))
def test_control_reaches_the_program(tmp_path, control):
    """The control's answers read far worse than the program's, on the
    same loads."""
    cell = cells.find("kkt2241_mg.rhs", tiny_root(tmp_path))
    runner.init_world(0, 1, str(tmp_path / "store"), torch.device("cpu"))
    try:
        out = {}
        for side in (None, control):
            run = runner.Run(cell, 5, 0, 1, torch.device("cpu"), control=side)
            assert run.config == {**cell.config, **cell.config["controls"].get(side, {})}
            run.prepare(1, 2)
            out[side] = run.readings(5, 2)
    finally:
        torch.distributed.destroy_process_group()
    assert out[None]["resid"] <= cell.config["limits"]["resid"]
    assert out[control]["resid"] > 30 * out[None]["resid"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,control", CONTROLS)
def test_control_fails_at_the_cells_size(workload, control):
    """On the card: the program's readings within every limit, the
    control's (three seeds) outside one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = cells.find(workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA devices")
    out = subprocess.run([sys.executable, str(ROOT / "kktbench/calibrate.py"), "--workload", workload, "--seeds",
                          "11", "--units", "2", "--control-seeds", "12,13,14", "--control-units", "2",
                          "--controls", control],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    s = last_json(out.stdout)
    limits = cell.config["limits"].items()
    assert all(s["program"][f"max_{k}"] <= lim for k, lim in limits)
    assert any(s[control][f"min_{k}"] > lim for k, lim in limits)
