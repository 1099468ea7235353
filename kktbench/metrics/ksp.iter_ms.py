"""ksp.iter_ms: milliseconds per Krylov iteration, the window's solve spans
(host clock, each ending in a synchronise) over its total iterations."""


def read(rec):
    its = sum(rec["its"])
    return 1e3 * sum(rec["spans"].get("solve", [])) / its if its else None
