"""The benchmark's yardstick: the table of peaks, the bytes a matvec must
move, and the clocks that time a chain of launches. Frozen here, so that a
later change to the program cannot move the ruler it is measured with.

Copied from the port (saddle_point_petsc_tpu_torch/benchmarks/harness.py):
`_chain_s` and `chain_rate` (r and 2r launches, the minimum of two runs
each, per launch (t(2r) - t(r)) / r, CUDA events on the card), and
`bandwidth_bytes_per_s` (a device copy, 2N bytes over the fastest of five).
The byte count of kernel B1 (the 9-point 2 x 2-block stencil matvec) is
the one the port's kernel table uses: every plane value read once, x read
and y written once, `itemsize * planes.numel() * (1 + 4/36)`.
"""
from __future__ import annotations

import time

import torch

# Published peaks by the name torch.cuda.get_device_name() gives (NVIDIA's
# data sheet, SXM part, at its 700 W limit; dense rates)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12, "f64_flop_per_s": 34e12},
}


def peak(kind, key):
    """The published peak `key` of the card named `kind`, or None."""
    return PEAKS.get(kind, {}).get(key)


def b1_bytes(planes):
    """Bytes one application of the stencil matvec must move: the planes
    (4, 3, 3, my, mx) once, x (2, my, mx) read and y written once."""
    return planes.element_size() * planes.numel() * (1 + 4 / 36)


def chain_seconds(step, x, r, dev):
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


def chain_rate(step, x, reps, dev):
    """Seconds per application of a dependent chain: r and 2r
    applications, the minimum of two runs each, after one warm
    application."""
    chain_seconds(step, x, 1, dev)
    t1 = min(chain_seconds(step, x, reps, dev) for _ in range(2))
    t2 = min(chain_seconds(step, x, 2 * reps, dev) for _ in range(2))
    return max(t2 - t1, 1e-9) / reps


def bandwidth_bytes_per_s(dev, mib):
    """Device memory bandwidth from a copy_ of `mib` MiB: 2N bytes a copy
    over the fastest of five, each timed with CUDA events."""
    n = mib * 2**20 // 4
    a = torch.ones(n, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    b.copy_(a)
    best = min(chain_seconds(lambda _: b.copy_(a), None, 1, dev) for _ in range(5))
    return 2 * a.numel() * a.element_size() / best
