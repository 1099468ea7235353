"""pcsetup.eigest_s: seconds in the `PCChebyEigEst` spans (the Chebyshev
smoothers' power iterations, with their CPU draws of the start vector) per
system set up, host clock, over the spans probe's units
(kktbench/spans.py)."""
from kktbench import spans


def probe(run):
    return spans.per_system(run, lambda out: out["spans"].get("PCChebyEigEst", {}).get("host_s", 0.0), "PCSetUp",
                           device=False)


def read(rec):
    return rec["probes"].get("pcsetup.eigest_s")
