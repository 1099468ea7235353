"""b1.launches_per_it: kernel B1 launches per Krylov iteration over the
spans probe's solves (kktbench/spans.py): what the program's counter
`B1.launches` moved, over the probe's iterations. A MINRES + Schur(diag,
MG) solve of `its` iterations makes its + 1 operator matvecs and its + 2
V-cycles of 49 launches each on config 5's six split levels."""
from kktbench import spans


def probe(run):
    out = spans.usable(run)
    moved = out["counters"] if out else None
    if not moved or not moved.get("B1.launches"):
        return None
    return moved["B1.launches"] / out["its"]


def read(rec):
    return rec["probes"].get("b1.launches_per_it")
