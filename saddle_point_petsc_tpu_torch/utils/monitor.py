"""Phase timers and solve summaries (PyTorch twin of
`saddle_point_petsc_tpu.utils.monitor`, PETSc -log_view style).

Phase times are host wall-clock times. PyTorch returns before a CUDA
device finishes, so a phase that ends in device work passes its output
as `sync=`: the phase then waits for the device(s) those tensors live on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class PhaseStats:
    name: str
    count: int = 0
    total_s: float = 0.0
    flops: float = 0.0
    nnz_processed: float = 0.0

    @property
    def nnz_per_s(self):
        return self.nnz_processed / self.total_s if self.total_s else 0.0

    @property
    def gflops(self):
        return self.flops / self.total_s / 1e9 if self.total_s else 0.0


def _flatten(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _flatten(o)


def synchronize(obj):
    """Wait for the CUDA devices holding any tensor in `obj` (a tensor or
    nested tuples/lists of tensors)."""
    for dev in {t.device for t in _flatten(obj) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class LogView:
    """Named phase timers (PETSc -log_view equivalent)."""

    def __init__(self):
        self.phases: Dict[str, PhaseStats] = {}
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name, flops=0.0, nnz=0.0, sync=None):
        """Time a block; `sync` names tensors whose devices to wait for at its end."""
        st = self.phases.setdefault(name, PhaseStats(name))
        t = time.perf_counter()
        try:
            yield st
        finally:
            if sync is not None:
                synchronize(sync)
            st.count += 1
            st.total_s += time.perf_counter() - t
            st.flops += flops
            st.nnz_processed += nnz

    def report(self, file=None):
        file = file or sys.stdout
        total = time.perf_counter() - self.t0
        print("-" * 78, file=file)
        print(
            f"{'Phase':<28}{'Count':>6}{'Time (s)':>12}{'%T':>6}"
            f"{'GFlop/s':>10}{'Gnnz/s':>10}",
            file=file,
        )
        print("-" * 78, file=file)
        for st in self.phases.values():
            pct = 100.0 * st.total_s / total if total else 0.0
            print(
                f"{st.name:<28}{st.count:>6}{st.total_s:>12.4f}{pct:>6.1f}"
                f"{st.gflops:>10.2f}{st.nnz_per_s / 1e9:>10.3f}",
                file=file,
            )
        print("-" * 78, file=file)


def spmv_flops(nnz):
    """2 flops per stored entry."""
    return 2.0 * nnz


def solve_summary(result, nnz=None, elapsed_s=None):
    """Structured run summary (its, rnorm, nnz/s) as a dict."""
    out = {
        "iterations": int(result.iterations),
        "rnorm": float(result.rnorm),
        "rnorm0": float(result.rnorm0),
        "converged_reason": result.reason_name(),
    }
    if nnz is not None and elapsed_s:
        # 1 SpMV per iteration is the dominant nnz traffic
        out["nnz_per_s"] = nnz * max(int(result.iterations), 1) / elapsed_s
        out["elapsed_s"] = elapsed_s
    return out


def residual_history(result):
    h = np.asarray(result.history)
    return h[h >= 0]
