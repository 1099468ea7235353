"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 kktbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name (kktbench/cells.py). A cell on c cards starts
c - 1 more processes of this file, one a card, meeting at a FileStore
under TMPDIR; this process is rank 0 and prints the result as the last
line of standard output, after the compared numbers as the last lines of
standard error. It exits non-zero, printing no result, without c cards,
when a check fails to run, or when jax, jaxlib, flax or the JAX package
were loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))



def use_checkout_caches():
    """Build and kernel caches at fixed places inside the checkout (the
    port itself builds into saddle_point_petsc_tpu_torch/csrc/_build/);
    no library may load flax."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / ".kktbench_cache" / sub))
    os.environ.setdefault("USE_FLAX", "0")


BANNED = ("jax", "jaxlib", "flax", "saddle_point_petsc_tpu")


def banned_modules():
    """Loaded modules whose top-level name is one of BANNED, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # internal: a rank started by rank 0
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--platform", default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    return p.parse_args(argv)


def spawn(script, argv, chips, platform, store, t_start):
    """Ranks 1 .. chips - 1: `script` again, their output to stderr."""
    return [subprocess.Popen([sys.executable, str(script), *argv, "--rank", str(r),
                              "--store", store, "--t-start", repr(t_start), "--platform", platform],
                             stdout=sys.stderr)
            for r in range(1, chips)]


def stop(children, timeout=60):
    """Wait for every child; end those still running after `timeout`.
    Returns their exit codes."""
    deadline = time.time() + timeout
    codes = []
    for c in children:
        try:
            codes.append(c.wait(max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            c.terminate()
            try:
                codes.append(c.wait(10))
            except subprocess.TimeoutExpired:
                c.kill()
                codes.append(c.wait())
    return codes


def with_ranks(argv, chips, platform, body, script=__file__):
    """body(store) as rank 0 in this process beside chips - 1 ranks of
    `script`; its value, or SystemExit when a rank failed."""
    tmp = tempfile.mkdtemp(prefix="kktbench-", dir=os.environ.get("TMPDIR"))
    store = os.path.join(tmp, "store")
    children = spawn(script, argv, chips, platform, store, T_START) if chips > 1 else []
    try:
        out = body(store)
    except BaseException:
        stop(children, timeout=5)
        raise
    finally:
        codes = stop(children)
        shutil.rmtree(tmp, ignore_errors=True)
    if any(codes):
        raise SystemExit(f"kktbench: a rank exited with {codes}")
    return out


def result_line(cell, rec, trace):
    """The JSON result from rank 0's record: metrics by the cell's readers,
    device-sourced ones only from a card; `checks` last."""
    metrics = {}
    for m in cell.reported(trace):
        if rec["platform"] != "gpu" and m.source == "device_trace":
            continue
        v = m.reader.read(rec)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in rec["checks"].items()}
    correct = all(v <= lim for v, lim in rec["checks"].values())
    device = {"platform": rec["platform"], "kind": rec["device_kind"], "count": rec["world"],
              "memory_peak_bytes": int(rec["peak_bytes"])}
    line = {"correct": correct, "attempted": rec["units"], "failed": rec["failed"], "metrics": metrics,
            "device": device}
    if trace and rec["trace"] and rec["platform"] == "gpu":
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in rec["trace"]["device_ops"]],
                             "idle_gaps": [list(x) for x in rec["trace"]["idle_gaps"]]}
    line["checks"] = checks
    return line


def run_rank(args, cell, platform, store, t_start):
    """This process's rank of the run; rank 0 returns its record."""
    # set-up by step: the interpreter and the imports (torch, the program,
    # the problem), then the card and the process group, then the Run's
    t = time.time()
    steps = {"imports": t - t_start}
    import torch

    from kktbench import runner

    dev = torch.device("cuda", args.rank) if platform == "gpu" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    runner.init_world(args.rank, cell.chips, store, dev)
    try:
        run = runner.Run(cell, args.seed, args.rank, cell.chips, dev)
        steps["world"] = time.time() - t
        rec = run.measure(args.seconds, args.trace, t_start, steps)
    finally:
        torch.distributed.destroy_process_group()
    if rec is not None:
        rec["power"] = runner.power_line(dev)
    return rec


def report(rec, line):
    """The earlier lines on stderr, then the compared numbers last."""
    solves = rec["spans"].get("solve", [])
    if solves:
        qs = statistics.quantiles(solves, n=20) if len(solves) > 1 else solves * 19
        print(f"kktbench: {len(solves)} solves, median {statistics.median(solves):.6f} s, p95 {qs[18]:.6f} s "
              f"per solve; {rec['checked']} answers checked; card {rec['power']}", file=sys.stderr)
    print("kktbench: setup " + ", ".join(f"{k} {v:.3f} s" for k, v in rec["setup_steps"].items())
          + f"; setup_s {rec['setup_s']:.3f} s", file=sys.stderr)
    for name, probe in rec["probes"].items():
        print(f"kktbench: probe {name} {probe}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


def main(argv=None, platform="gpu", script=__file__):
    """One run; `platform` "cpu" (the tests) skips the look for cards and
    runs every rank on the CPU over gloo. Ranks past 0 run `script`."""
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    platform = args.platform or platform
    use_checkout_caches()
    from kktbench import cells

    cell = cells.find(args.workload, args.root)
    if args.rank:
        run_rank(args, cell, platform, args.store, args.t_start)
        return 0
    if platform == "gpu":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"kktbench: {args.workload} needs {cell.chips} CUDA devices; {n} available", file=sys.stderr)
            return 2
    rec = with_ranks(argv, cell.chips, platform, lambda store: run_rank(args, cell, platform, store, T_START),
                     script=script)
    found = banned_modules()
    if found:
        print(f"kktbench: loaded {found}; the benchmark may load none of {BANNED}", file=sys.stderr)
        return 3
    line = result_line(cell, rec, args.trace)
    report(rec, line)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
