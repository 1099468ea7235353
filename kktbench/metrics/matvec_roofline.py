"""matvec_roofline: the finest operator's matvec K.A(x), timed as a chain
of dependent launches with CUDA events (kktbench/yardstick.py), as a share
of its bound: the bytes it must move (the planes once, x and y once) over
the card's published bandwidth; in %. The bound counts the work, not the
kernel, so it reads the same whatever kernel the program runs."""
from kktbench import yardstick

REPS = 50


def probe(run):
    """Seconds per matvec of this rank's operator, and its bytes."""
    if run.state is None or run.dev.type != "cuda":
        return None
    A = run.state[0].A
    # the chain's values grow with each product and may reach inf in
    # float32; the card's time for a product does not depend on them
    x = 1e-3 * A.diagonal().clone()
    dt = yardstick.chain_rate(A, x, REPS, run.dev)
    # the bandwidth a device copy reaches in the same run, for the record
    copy = yardstick.bandwidth_bytes_per_s(run.dev, 1024)
    return {"seconds": dt, "bytes": yardstick.b1_bytes(A.planes), "copy_bytes_per_s": copy}


def read(rec):
    p = rec["probes"].get("matvec_roofline")
    bw = yardstick.peak(rec["device_kind"], "hbm_bytes_per_s")
    if not p or not bw or rec["world"] != 1:
        return None
    return 100.0 * p["bytes"] / bw / p["seconds"]
