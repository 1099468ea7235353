"""ksp.its: mean Krylov iterations per solve in the window
(KrylovResult.iterations)."""
import statistics


def read(rec):
    return statistics.fmean(rec["its"]) if rec["its"] else None
