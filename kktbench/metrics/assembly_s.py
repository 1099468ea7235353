"""assembly_s: mean seconds of assemble_saddle_dist per system in the
window, a host span ending in a synchronise."""
import statistics


def read(rec):
    spans = rec["spans"].get("assemble")
    return statistics.fmean(spans) if spans else None
