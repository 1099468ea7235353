"""gamg.host_s: host seconds in the distributed gamg set-up's spans
(`GAMGRho`, `GAMGAggregate`, `GAMGProlong`, `GAMGGalerkin`,
`GAMGLevelBuild` `Lk` and `GAMGCoarseSetUp`, all under `PCSetUp`) per
system set up, over the spans probe's units (kktbench/spans.py)."""
from kktbench import spans


def _seconds(out):
    return sum(r["host_s"] for k, r in out["spans"].items() if k.startswith("GAMG"))


def probe(run):
    out = spans.usable(run)
    # None where the program has no such span (a program older than it)
    if out is None or not any(k.startswith("GAMG") for k in out["spans"]):
        return None
    return spans.per_system(run, _seconds, "PCSetUp", device=False)


def read(rec):
    return rec["probes"].get("gamg.host_s")
