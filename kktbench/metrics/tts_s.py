"""tts_s: seconds to the solution of a new system (assemble, set up, solve),
the window over the systems completed in it (host clock)."""


def read(rec):
    return rec["window_s"] / rec["units"] if rec["rebuild"] == "every_unit" else None
