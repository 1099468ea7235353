"""The readings that the limits of `correct` are set from (kktbench/README.md):
in one process (one a card for a four-card cell), the program's compared
numbers on each of `--seeds`, then each control's on each of
`--control-seeds`: the cell's configuration with an entry of its
`controls` applied (the nearest precision below the one it states, or a
stated guarantee broken). Every unit's answer is checked. The benchmark's
own runs never run this.

    python3 kktbench/calibrate.py --workload <name> --seeds 1,2,3 --units 30 \
        [--control-seeds 4,5,6 --control-units 4 --controls float32,...]

Prints one line a seed: side, seed, each number's worst reading over the
units, the unconverged solves, and the mean, least and most iterations;
and a JSON summary (each side's largest and least reading of each number)
last.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kktbench import run as R  # noqa: E402


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--units", type=int, default=8)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-units", type=int, default=4)
    p.add_argument("--controls", default=None, help="comma-separated; default: every control of the configuration")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--store", default=None)
    p.add_argument("--t-start", type=float, default=None)
    p.add_argument("--platform", default="gpu")
    p.add_argument("--root", default=str(R.ROOT))
    return p.parse_args(argv)


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def rank_main(args, cell, store):
    import torch

    from kktbench import runner

    dev = torch.device("cuda", args.rank) if args.platform == "gpu" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    runner.init_world(args.rank, cell.chips, store, dev)
    controls = args.controls.split(",") if args.controls is not None else list(cell.config["controls"])
    sides = [("program", None, seeds(args.seeds), args.units)]
    sides += [(c, c, seeds(args.control_seeds), args.control_units) for c in controls]
    out = {side: [] for side, *_ in sides}
    try:
        for side, control, ss, units in sides:
            if not ss:
                continue
            run = runner.Run(cell, ss[0], args.rank, cell.chips, dev, control=control)
            run.prepare(int(cell.traffic["warm_units"]), units)
            for s in ss:
                t0 = time.perf_counter()
                r = run.readings(s, units)
                if r is not None:
                    out[side].append({"seed": s, **r})
                    print(f"{side} seed {s} " + " ".join(f"{k} {v!r}" for k, v in r.items())
                          + f" ({time.perf_counter() - t0:.1f} s, {units} units)", flush=True)
            run.free()
            del run
    finally:
        torch.distributed.destroy_process_group()
    return out


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    R.use_checkout_caches()
    from kktbench import cells

    cell = cells.find(args.workload, args.root)
    if args.rank:
        rank_main(args, cell, args.store)
        return 0
    argv = sys.argv[1:] if argv is None else argv
    out = R.with_ranks(argv, cell.chips, args.platform, lambda store: rank_main(args, cell, store), script=__file__)
    keys = (*cell.problem.NUMBERS, "unconverged")
    summary = {side: {f"{m}_{k}": f(r[k] for r in rows) for k in keys for m, f in (("max", max), ("min", min))}
               if rows else {} for side, rows in out.items()}
    print(json.dumps({"workload": args.workload, "units": args.units, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
