"""The program's own spans and counters (the port's utils/monitor.py) over a
few more units of a run: one profiled pass, shared by the per-layer readers
that split the solve and the set-up by program span.

`probe(run)` runs the mix's `trace_units` more units under torch.profiler,
keyed (TRACED, trace_units + k) so that their loads are fresh, snapshots
the program's counter table around them, and reduces the trace by program
span. A span is a user annotation on the main thread: the program's, and
the benchmark's own (`kktbench.*`), which hold what a unit runs outside
the program's spans. Inside the probe's window (the first of its units to
the end of the last):

- each span's count and host seconds;
- device-busy seconds of the kernels (copies, sets) it launched: each
  device activity is matched to its runtime launch call by correlation id
  and charged to the innermost span open at that call;
- device-idle seconds, each gap charged to the innermost span covering
  its middle (a `kktbench.*` span where no span of the program is open).

Busy and idle seconds are kept by innermost span (the table) and by group:
a group takes every activity or gap with one of its spans anywhere in the
stack of spans open over it (`GROUPS`). The result is cached on the run;
rank 0 prints the table once on stderr. A reader returns None where the
probe has nothing for it: a device number off the card (no device
activity, no kernel launch), where the program has no such span or
counter (a program older than its tracing layer), or where a unit of the
probe did not converge.
"""
from __future__ import annotations

import collections
import sys

from torch.profiler import ProfilerActivity, profile

from kktbench import loads as L
from kktbench import trace as T

# a stack of open spans (outer to inner) belongs to a group when ...
GROUPS = {
    "solve": lambda st: "KSPSolve" in st,
    # the Krylov loop's own body: the solve outside the PC applies
    "ksp": lambda st: "KSPSolve" in st and "PCApply" not in st,
    "mg": lambda st: "MGApply" in st,
    "pcsetup": lambda st: "PCSetUp" in st,
    "eigest": lambda st: "PCChebyEigEst" in st,
    "assembly": lambda st: "MatAssembly" in st,
}
NONE = "(no span)"
B1_KERNEL = "stencil_spmv_kernel"  # kernel B1's name in the device trace


def _span(e, main):
    return not T._on_device(e) and e.start_thread_id() == main and e.is_user_annotation()


def stacks_at(spans, times):
    """For each time in `times`, the names of the spans covering it, outer
    to inner; spans = (start, end, name), properly nested."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [()] * len(times)
    stack, k = [], 0
    for i in order:
        t = times[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


def reduce_trace(events):
    """The probe's numbers from a finished trace's events (None without a
    `kktbench.unit` span)."""
    units = [(T._start_ns(e), T._start_ns(e) + T._dur_ns(e), e.start_thread_id()) for e in events
             if not T._on_device(e) and e.name() == T.UNIT]
    if not units:
        return None
    lo, hi = min(u[0] for u in units), max(u[1] for u in units)
    main = units[0][2]
    spans, launch_at, device = [], {}, []
    for e in events:
        s = T._start_ns(e)
        t = s + T._dur_ns(e)
        if T._on_device(e):
            if not T._annotation(e) and t > lo and s < hi:
                device.append((max(s, lo), min(t, hi), e.correlation_id(), e.name()))
        elif _span(e, main):
            spans.append((s, t, e.name()))
        elif e.name().startswith("cu") and e.correlation_id():  # a runtime or driver call
            launch_at[e.correlation_id()] = s

    table = collections.defaultdict(lambda: {"count": 0, "host_s": 0.0, "busy_s": 0.0, "idle_s": 0.0,
                                             "launches": 0})
    for s, t, name in spans:
        table[name]["count"] += 1
        table[name]["host_s"] += (t - s) / 1e9
    busy_by = collections.defaultdict(list)
    matched = [d for d in device if d[2] in launch_at]
    unmatched = len(device) - len(matched)
    b1_in_solve = 0
    for (s, t, _, name), st in zip(matched, stacks_at(spans, [launch_at[d[2]] for d in matched])):
        row = table[st[-1] if st else NONE]
        row["busy_s"] += (t - s) / 1e9
        row["launches"] += 1
        for g, inside in GROUPS.items():
            if inside(st):
                busy_by[g].append((s, t))
        if B1_KERNEL in name and "KSPSolve" in st:
            b1_in_solve += 1
    busy = T.union([(s, t) for s, t, _, _ in device])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle_by = collections.Counter()
    for (s, t), st in zip(gaps, stacks_at(spans, [(s + t) / 2 for s, t in gaps])):
        table[st[-1] if st else NONE]["idle_s"] += (t - s) / 1e9
        for g, inside in GROUPS.items():
            if inside(st):
                idle_by[g] += (t - s) / 1e9
    # the idle time inside the KSPSolve spans, each gap cut at their edges
    solves = T.union([(s, t) for s, t, name in spans if name == "KSPSolve"])
    idle_in_solve = sum(T._length(T._clip(solves, s, t)) for s, t in gaps) / 1e9
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": T._length(busy) / 1e9,
        "busy_by": {g: T._length(T.union(iv)) / 1e9 for g, iv in busy_by.items()},
        "idle_by": dict(idle_by),
        "idle_in_solve_s": idle_in_solve,
        "unmatched": unmatched,
        "b1_kernels_in_solve": b1_in_solve,
        "spans": {k: dict(v) for k, v in table.items()},
    }


def _print(out):
    print(f"kktbench: spans probe, {out['units']} units, {out['its']} its, {out['unconverged']} unconverged; "
          f"window {out['window_s']:.6f} s, device busy {out['busy_s']:.6f} s; counters moved {out['counters']}",
          file=sys.stderr)
    print(f"kktbench: spans busy_by {out['busy_by']} idle_by {out['idle_by']} idle inside KSPSolve "
          f"{out['idle_in_solve_s']:.6f} s; {out['unmatched']} device activities matched no launch call; "
          f"{out['b1_kernels_in_solve']} B1 kernels launched under KSPSolve", file=sys.stderr)
    outside = {k: round(r["idle_s"], 6) for k, r in out["spans"].items() if k.startswith("kktbench.")}
    print(f"kktbench: spans device idle outside the program's spans, inside the units: {outside}", file=sys.stderr)
    print(f"kktbench: spans {'span':<22}{'count':>7}{'host_s':>12}{'busy_s':>12}{'idle_s':>12}{'launches':>9}",
          file=sys.stderr)
    for name, r in sorted(out["spans"].items(), key=lambda kv: -kv[1]["host_s"]):
        print(f"kktbench: spans {name:<22}{r['count']:>7}{r['host_s']:>12.6f}{r['busy_s']:>12.6f}"
              f"{r['idle_s']:>12.6f}{r['launches']:>9}", file=sys.stderr)


def _counters():
    """The program's counter table, or None where it has none."""
    from saddle_point_petsc_tpu_torch.utils import monitor

    table = getattr(monitor, "counters", None)
    return dict(table) if isinstance(table, dict) else None


def probe(run):
    """The shared profiled pass of `run` (a kktbench.runner.Run), computed
    once."""
    if hasattr(run, "_spans_probe"):
        return run._spans_probe
    on_card = run.dev.type == "cuda"
    units = int(run.cell.traffic["trace_units"])
    before, failed, first = _counters(), run.failed, len(run.its)
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        for k in range(units):
            run.unit((L.TRACED, units + k))
        run.sync()
    after = _counters()
    out = reduce_trace(prof.profiler.kineto_results.events())
    if out is not None:
        moved = None
        if before is not None and after is not None:
            moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        out.update(on_card=on_card, units=units, its=sum(run.its[first:]), unconverged=run.failed - failed,
                   counters=moved)
        if run.rank == 0:
            _print(out)
    run._spans_probe = out
    return out


def usable(run):
    """The probe of `run` where every unit of it converged, else None."""
    out = probe(run)
    return out if out is not None and out["unconverged"] == 0 and out["its"] else None


def count(out, span):
    """How many times `span` ran in the probe."""
    return out["spans"].get(span, {}).get("count", 0)


def per_iteration(run, kind, group, span):
    """Milliseconds of device `kind` ("busy" or "idle") in `group` per
    Krylov iteration of the probe; None off the card or where `span` never
    ran."""
    out = usable(run)
    if out is None or not out["on_card"] or not count(out, span):
        return None
    return 1e3 * out[f"{kind}_by"].get(group, 0.0) / out["its"]


def per_system(run, seconds, span, device=True):
    """seconds(probe) over the times `span` ran (one a system: its assembly
    or its set-up); None where it never ran, and for a `device` number off
    the card."""
    out = usable(run)
    n = count(out, span) if out and (out["on_card"] or not device) else 0
    return seconds(out) / n if n else None
