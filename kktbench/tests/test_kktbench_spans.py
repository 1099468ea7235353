"""The spans probe (kktbench/spans.py) and its six readers: the reduction
of a trace by span on a made-up trace of the card (device activities
matched to their launch calls, idle gaps by their middle, the groups), and
a tiny CPU run, where only the host-clock reader reads."""
from __future__ import annotations

import subprocess
import sys

import pytest
from kkt_tiny import ROOT, last_json, tiny_root

from kktbench import spans

DEVICE_READERS = ("b1.launches_per_it", "mg.idle_ms_per_it", "ksp.idle_ms_per_it", "pcsetup.device_s",
                  "assembly.device_s")


class Ev:
    """A profiler event: a host span or call (corr > 0: a runtime call), or
    a device activity."""

    def __init__(self, name, start, end, device=False, corr=0, annotation=False):
        self._name, self._s, self._e = name, start, end
        self._dev, self._corr, self._ann = device, corr, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return 7

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ann


def _span(name, s, e):
    return Ev(name, s, e, annotation=True)


def _trace():
    return [
        _span("kktbench.unit", 0, 100), _span("kktbench.solve", 1, 99), _span("KSPSolve", 10, 90),
        _span("PCApply", 20, 50), _span("MGApply", 21, 49), _span("MatMult", 55, 60),
        Ev("cudaLaunchKernel", 4, 5, corr=3), Ev("elementwise", 5, 8, device=True, corr=3),
        Ev("cudaLaunchKernel", 22, 23, corr=1), Ev("stencil_spmv_kernel<double>", 30, 40, device=True, corr=1),
        Ev("cudaLaunchKernel", 56, 57, corr=2), Ev("elementwise", 58, 70, device=True, corr=2),
        Ev("MGApply", 21, 49, device=True, annotation=True),  # the span drawn on the device's timeline
        Ev("aten::add", 56, 57),
    ]


def test_stacks_at():
    got = spans.stacks_at([(0, 100, "a"), (10, 20, "b"), (12, 14, "c"), (30, 40, "d")], [13, 20, 25, 35, 101])
    assert got == [("a", "b", "c"), ("a", "b"), ("a",), ("a", "d"), ()]


def test_reduce_trace_by_span():
    out = spans.reduce_trace(_trace())
    ns = 1e-9
    assert out["window_s"] == pytest.approx(100 * ns) and out["busy_s"] == pytest.approx(25 * ns)
    # kernels charged where they were launched, not where they ran
    assert out["busy_by"] == pytest.approx({"solve": 22 * ns, "mg": 10 * ns, "ksp": 12 * ns})
    # gaps [0, 5], [8, 30], [40, 58], [70, 100] by their middles
    assert out["idle_by"] == pytest.approx({"solve": 70 * ns, "mg": 18 * ns, "ksp": 52 * ns})
    assert out["idle_in_solve_s"] == pytest.approx(58 * ns)
    assert out["unmatched"] == 0 and out["b1_kernels_in_solve"] == 1
    table = out["spans"]
    assert table["kktbench.solve"]["busy_s"] == pytest.approx(3 * ns) and table["kktbench.solve"]["launches"] == 1
    assert table["kktbench.solve"]["idle_s"] == pytest.approx(5 * ns)  # the gap [0, 5], before KSPSolve
    assert table["MGApply"]["count"] == 1 and table["MGApply"]["idle_s"] == pytest.approx(18 * ns)
    assert table["MatMult"]["busy_s"] == pytest.approx(12 * ns)


def test_reduce_trace_without_units():
    assert spans.reduce_trace([_span("KSPSolve", 0, 10)]) is None


def test_readers_read_nothing_off_the_card(tmp_path):
    """A tiny `.system` run on the CPU with --trace 1: the probe's table on
    stderr, `pcsetup.eigest_s` read from the host's spans, no device
    reader in the line."""
    root = tiny_root(tmp_path)
    argv = ["--workload", "kkt2241_mg.system", "--seed", str(2**31 + 29), "--seconds", "0.5", "--trace", "1",
            "--root", str(root), "--platform", "cpu"]
    out = subprocess.run([sys.executable, str(ROOT / "kktbench" / "run.py"), *argv], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = last_json(out.stdout)
    assert line["correct"] is True and line["metrics"]["pcsetup.eigest_s"]["value"] > 0
    assert not set(DEVICE_READERS) & set(line["metrics"])
    table = [e.split()[2] for e in out.stderr.splitlines() if e.startswith("kktbench: spans ")]
    assert {"MatAssembly", "PCSetUp", "PCChebyEigEst", "KSPSolve", "MGApply"} <= set(table)
