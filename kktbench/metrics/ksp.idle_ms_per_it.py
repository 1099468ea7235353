"""ksp.idle_ms_per_it: milliseconds a Krylov iteration in which the device
ran nothing while the host was in the Krylov loop's own body (under
`KSPSolve` and outside `PCApply`: `MatMult`, the vector updates and
`KSPConvergedTest`, MINRES's one host sync an iteration), over the spans
probe's solves (kktbench/spans.py)."""
from kktbench import spans


def probe(run):
    return spans.per_iteration(run, "idle", "ksp", "KSPSolve")


def read(rec):
    return rec["probes"].get("ksp.idle_ms_per_it")
