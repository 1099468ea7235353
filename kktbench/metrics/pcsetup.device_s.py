"""pcsetup.device_s: device-busy seconds of the kernels, copies and sets
launched under `PCSetUp` (KSP.set_up) per system, over the spans probe's
units (kktbench/spans.py)."""
from kktbench import spans


def probe(run):
    return spans.per_system(run, lambda out: out["busy_by"].get("pcsetup", 0.0), "PCSetUp")


def read(rec):
    return rec["probes"].get("pcsetup.device_s")
