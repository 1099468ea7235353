"""Reduction of a torch.profiler trace to what the per-layer readers use.

The profiler's events stay in memory (`prof.profiler.kineto_results`);
nothing is written to disk. `summarize` keeps, inside the traced window
(from the first `kktbench.unit` span to the end of the last):

- the union of the device's activity (kernels, copies, sets): busy time;
- device seconds by kernel name (the breakdown's `device_ops`);
- each idle gap of the device, charged to the innermost host span of the
  main thread that covers its middle (`idle_gaps`).
"""
from __future__ import annotations

import collections

UNIT = "kktbench.unit"


def _start_ns(e):
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e):
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _on_device(e):
    return str(e.device_type()).rsplit(".", 1)[-1] != "CPU"


def _annotation(e):
    """A span of the benchmark's (record_function), which the profiler
    also draws on the device's timeline: no device work."""
    return e.name().startswith("kktbench.") or (hasattr(e, "is_user_annotation") and e.is_user_annotation())


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def _length(intervals):
    return sum(e - s for s, e in intervals)


def _charge_gaps(gaps, host):
    """Seconds of device idle by the innermost host span covering each
    gap's middle; host = (start, end, name) of one thread, nested."""
    host = sorted(host, key=lambda t: (t[0], -t[1]))
    by_name = collections.Counter()
    stack, k = [], 0
    for s, e in sorted(gaps):
        mid = (s + e) / 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        by_name[stack[-1][2] if stack else "(no host span)"] += (e - s) / 1e9
    return by_name


def summarize(prof):
    """The traced window's numbers from a finished torch.profiler.profile,
    or None when it holds no `kktbench.unit` span."""
    events = prof.profiler.kineto_results.events()
    units = [(_start_ns(e), _start_ns(e) + _dur_ns(e), e.start_thread_id()) for e in events
             if not _on_device(e) and e.name() == UNIT]
    if not units:
        return None
    lo, hi = min(u[0] for u in units), max(u[1] for u in units)
    main = units[0][2]
    dev, host = [], []
    kernel_s = collections.Counter()
    for e in events:
        s = _start_ns(e)
        t = s + _dur_ns(e)
        if t <= lo or s >= hi:
            continue
        name = e.name()
        if _on_device(e):
            if _annotation(e):
                continue
            dev.append((s, t))
            kernel_s[name] += (min(t, hi) - max(s, lo)) / 1e9
        elif e.start_thread_id() == main:
            host.append((s, t, name))
    busy = _clip(union(dev), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": _length(busy) / 1e9,
        "device_ops": kernel_s.most_common(10),
        "idle_gaps": _charge_gaps(gaps, host).most_common(10),
    }
