"""The port's tracing layer: spans on the profiler's clock, one counter
table, and the -log_view phase timers (the PyTorch side of
`saddle_point_petsc_tpu.utils.monitor`, PETSc -log_view style).

- `span(name)`: a context around a piece of work, named after PETSc's
  -log_view events (KSPSolve, MatMult, PCApply, PCSetUp, MatAssembly, ...).
  While a torch profiler is recording it is a
  `torch.profiler.record_function`: a user annotation in the same trace,
  on the same clock, as the kernels, copies and runtime calls, so every
  idle gap of the device falls under the span the host was in. Otherwise
  it is one shared no-op context, which costs a flag check. The profiler
  being on is the only switch (`-profile`, or any caller's
  torch.profiler.profile).
- `counters`: a plain dict of ints, always on. `count(name, n)` adds,
  `reset_counters()` clears. The kernel modules count launches
  (`B1.launches`, `B1.launches.padded`, `B1.launches.float64`, ... B2-B6,
  `FE.launches`, `FE.launches.float64`, ... of the assembly kernel, and
  `RN.launches`, `RN.launches.float32`, `RN.launches.float64` of the
  normal draws of estimate_lmax's start vector, one a leaf on the card),
  and solvers/multigrid.py the coarsest levels inverted on the card
  (`MGCoarse.device`, one a set-up); solvers/amg.py's streaming gamg
  set-up counts the levels of each hierarchy it builds, the coarsest
  included, and this rank's rows and entries of their operators
  (`GAMG.levels`, `GAMG.rows`, `GAMG.nnz`); parallel/dist_csr.py the
  bytes of host triplets that `ship_triplets` copies to the device and
  back (`triplets.h2d_bytes`, `triplets.d2h_bytes`), and the DistAIJ
  builds of `dist_aij_from_rows` with the bytes they and
  `dist_aij_to_dia` copy to the device and back (`aij_build.count`,
  `aij_build.h2d_bytes`, `aij_build.d2h_bytes`);
  parallel/halo.py counts the messages and bytes it posts, and
  `ProcessMesh` its all_reduce and all_to_all calls and bytes when the
  mesh has more than one rank.
- `LogView`: named phases on the host clock (each also a span), with what
  each phase moved in the counter table. PyTorch returns before a CUDA
  device finishes, so a phase that ends in device work passes its output
  as `sync=`: the phase then waits for the device(s) those tensors live on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
import time
from typing import Dict

import numpy as np
import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name):
    """A context naming the work inside it in a running profiler's trace;
    the shared no-op context when no profiler is recording."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


counters: Dict[str, int] = {}


def count(name, n=1):
    """Add n to the counter `name`."""
    counters[name] = counters.get(name, 0) + n


def reset_counters():
    counters.clear()


_LAUNCHES = re.compile(r"^((B\d|FE)\.launches|MGCoarse\.device)$")


def _moved(before, after):
    """(kernel launches, messages, bytes sent, all_reduces) between two
    snapshots of the counter table."""

    def d(key):
        return after.get(key, 0) - before.get(key, 0)

    launches = sum(v - before.get(k, 0) for k, v in after.items() if _LAUNCHES.match(k))
    messages = d("halo.messages") + d("all_to_all.messages")
    sent = d("halo.bytes") + d("all_to_all.bytes")
    return launches, messages, sent, d("all_reduce.calls")


@dataclasses.dataclass
class PhaseStats:
    name: str
    count: int = 0
    total_s: float = 0.0
    launches: int = 0  # kernel launches (B1-B6, FE) and coarse inverses on the card
    messages: int = 0  # halo and all_to_all messages posted
    bytes_sent: int = 0
    reductions: int = 0  # all_reduce calls


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
    def phase(self, name, sync=None):
        """Time a block, a span of the same name; `sync` names tensors whose
        devices to wait for at its end."""
        st = self.phases.setdefault(name, PhaseStats(name))
        before = dict(counters)
        t = time.perf_counter()
        try:
            with span(name):
                yield st
                if sync is not None:
                    synchronize(sync)
        finally:
            st.count += 1
            st.total_s += time.perf_counter() - t
            launches, messages, sent, reductions = _moved(before, counters)
            st.launches += launches
            st.messages += messages
            st.bytes_sent += sent
            st.reductions += reductions

    def report(self, file=None):
        """The phase table: count, seconds, share of the run, and the kernel
        launches, messages (with their mean length) and all_reduces each
        phase made (PETSc's Mess, AvgLen and Reduct)."""
        file = file or sys.stdout
        total = time.perf_counter() - self.t0
        print("-" * 78, file=file)
        print(
            f"{'Phase':<20}{'Count':>6}{'Time (s)':>12}{'%T':>6}"
            f"{'Launches':>10}{'Mess':>8}{'AvgLen':>10}{'Reduct':>8}",
            file=file,
        )
        print("-" * 78, file=file)
        for st in self.phases.values():
            pct = 100.0 * st.total_s / total if total else 0.0
            avg = st.bytes_sent / st.messages if st.messages else 0.0
            print(
                f"{st.name:<20}{st.count:>6}{st.total_s:>12.4f}{pct:>6.1f}"
                f"{st.launches:>10}{st.messages:>8}{avg:>10.3g}{st.reductions:>8}",
                file=file,
            )
        print("-" * 78, file=file)


def residual_history(result):
    h = np.asarray(result.history)
    return h[h >= 0]
