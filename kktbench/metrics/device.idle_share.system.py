"""device.idle_share.system: the share of the traced window in which rank
0's card ran nothing, in %, where every unit builds a new system."""


def read(rec):
    t = rec["trace"]
    if rec["rebuild"] != "every_unit" or not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
