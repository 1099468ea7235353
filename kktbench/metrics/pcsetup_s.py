"""pcsetup_s: mean seconds of KSP.set_up per system in the window, a host
span ending in a synchronise."""
import statistics


def read(rec):
    spans = rec["spans"].get("pcsetup")
    return statistics.fmean(spans) if spans else None
