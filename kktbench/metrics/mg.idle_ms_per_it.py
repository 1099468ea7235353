"""mg.idle_ms_per_it: milliseconds a Krylov iteration in which the device
ran nothing while the host was inside the MG V-cycle (any span under
`MGApply`: its levels' smoothing, residuals, restriction, prolongation and
coarse solve), over the spans probe's solves (kktbench/spans.py): the
host-bound share of the V-cycle's ~400 launches."""
from kktbench import spans


def probe(run):
    return spans.per_iteration(run, "idle", "mg", "MGApply")


def read(rec):
    return rec["probes"].get("mg.idle_ms_per_it")
