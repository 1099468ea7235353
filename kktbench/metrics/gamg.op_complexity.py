"""gamg.op_complexity: the gamg hierarchy's operator complexity, the
entries of every level's operator (the coarsest included) over the
finest's: what the program's counter `GAMG.nnz` moved over the spans
probe's set-ups (kktbench/spans.py), over their count and the entries of
the system's own matrix (this rank's true rows)."""
from kktbench import spans


def _entries(A):
    """Entries in this rank's true rows of the DistAIJ A."""
    rows = A.to_scipy_rows()
    lo = A.mesh.rank * A.n_loc
    return int(rows.indptr[max(min(A.n_loc, A.shape[0] - lo), 0)])


def probe(run):
    out = spans.usable(run)
    moved = out["counters"] if out else None
    setups = spans.count(out, "PCSetUp") if out else 0
    if not moved or not moved.get("GAMG.nnz") or not setups or run.state is None:
        return None
    A = run.state[0]
    if not hasattr(A, "to_scipy_rows"):
        return None
    return moved["GAMG.nnz"] / setups / _entries(A)


def read(rec):
    return rec["probes"].get("gamg.op_complexity")
