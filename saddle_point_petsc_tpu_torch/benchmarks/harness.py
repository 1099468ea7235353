"""The device, clocks, chains and operators that the bench
(saddle_point_petsc_tpu_torch/bench.py), run_configs.py and scaling.py
share.

Chains: r and 2r dependent applications, the minimum of two runs each,
per application (t(2r) - t(r)) / r, timed with CUDA events on the card
(every application is a launch from the host, so a kernel of a few
microseconds measures the launch rate) and on the host clock on the CPU.
Solves: the host clock between `torch.cuda.synchronize()` calls, after one
warm run.
"""
from __future__ import annotations

import contextlib
import os
import time

import scipy.sparse as sps
import torch
import torch.distributed as tdist

from saddle_point_petsc_tpu_torch.parallel import mesh as pmesh
from saddle_point_petsc_tpu_torch.solvers import krylov
from saddle_point_petsc_tpu_torch.utils.device import resolve_device


def bench_device():
    """The card (cuda:<current>), or the CPU when BENCH_CPU is set; raises
    without a card otherwise."""
    if os.environ.get("BENCH_CPU"):
        return torch.device("cpu")
    dev = resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chain_s(step, x, r, dev):
    """Seconds of r dependent applications of step from x: CUDA events on
    the card, the host clock on the CPU."""
    v = x
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(r):
            v = step(v)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(r):
        v = step(v)
    return time.perf_counter() - t0


def chain_rate(step, x, work, reps, dev, escalate=False, rcap=200_000):
    """(work per second, seconds per application) of a dependent chain: r
    and 2r applications, the minimum of two runs each. With `escalate`, r
    grows 8x until the difference exceeds 0.02 s or r reaches rcap
    (bench.py:608-627)."""
    _chain_s(step, x, 1, dev)
    r = reps
    while True:
        t1 = min(_chain_s(step, x, r, dev) for _ in range(2))
        t2 = min(_chain_s(step, x, 2 * r, dev) for _ in range(2))
        if not escalate or t2 - t1 > 0.02 or r >= rcap:
            break
        r *= 8
    dt = max(t2 - t1, 1e-9) / r
    return work / dt, dt


def timed_solve(run, dev):
    """(seconds, result) of run() after one warm run, on the host clock
    between synchronizations."""
    run()
    sync(dev)
    t0 = time.perf_counter()
    out = run()
    sync(dev)
    return time.perf_counter() - t0, out


def bandwidth_bytes_per_s(dev, mib):
    """Device memory bandwidth from a copy_ of `mib` MiB: 2N bytes a copy
    over the fastest of five, each timed with CUDA events (the host clock
    on the CPU)."""
    n = mib * 2**20 // 4
    a = torch.ones(n, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    b.copy_(a)
    best = min(_chain_s(lambda _: b.copy_(a), None, 1, dev) for _ in range(5))
    return 2 * a.numel() * a.element_size() / best


@contextlib.contextmanager
def world(dev):
    """The process group for dev: the initialized one, or a world of one
    started for the block (`init_from_env`) and destroyed after it."""
    dev, created = pmesh.init_from_env(dev)
    try:
        yield dev
    finally:
        if created:
            tdist.destroy_process_group()


@krylov.reduces_over_ranks
def prescale(A, x, steps=12):
    """A's planes over 1.05 times its power-iteration estimate of lambda_max
    after `steps` steps from x, and the last iterate: the operator of a pure
    matvec chain with bounded iterates (bench.py:73-81). Norms sum over
    A's ranks."""
    y = krylov.tscale(1.0 / krylov.tnorm(x), x)
    for _ in range(steps):
        y = A(y)
        y = krylov.tscale(1.0 / krylov.tnorm(y), y)
    return A.planes / (1.05 * krylov.tdot(y, A(y))), y


def poisson5(n, dtype="float32"):
    """The JAX bench's 5-point operator on an n^2 grid, 4 on each 1-D
    diagonal (bench.py:597-600), as scipy CSR."""
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n))
    return (sps.kron(sps.identity(n), t) + sps.kron(t, sps.identity(n))).tocsr().astype(dtype)
