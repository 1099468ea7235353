"""solve_s: seconds per solve, the window over the solves completed in it,
where the mix sets the system up once (host clock)."""


def read(rec):
    return rec["window_s"] / rec["units"] if rec["rebuild"] == "never" else None
