"""assembly.device_s: device-busy seconds of the kernels, copies and sets
launched under `MatAssembly` (assemble_saddle_dist) per system, over the
spans probe's units (kktbench/spans.py)."""
from kktbench import spans


def probe(run):
    return spans.per_system(run, lambda out: out["busy_by"].get("assembly", 0.0), "MatAssembly")


def read(rec):
    return rec["probes"].get("assembly.device_s")
