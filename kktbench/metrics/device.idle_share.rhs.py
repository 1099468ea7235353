"""device.idle_share.rhs: the share of the traced window in which rank 0's
card ran nothing (kernels, copies and sets as one union), in %, where the
mix sets the system up once."""


def read(rec):
    t = rec["trace"]
    if rec["rebuild"] != "never" or not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
