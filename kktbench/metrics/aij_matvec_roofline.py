"""aij_matvec_roofline: the finest DistAIJ's matvec A.matvec(x) (kernel
B3 on a banded local block, else B5) on the card, as a share of its
bound: the bytes the work must move over the card's published bandwidth;
in %. The bound counts the work, not the format: every stored entry read
once, x read and y written once, `itemsize * (nnz + 2 * n_rows)` of this
rank's true rows, whatever layout or kernel the program runs.

The operator and x (about 29 MB in f32 at 1024^2) fit in the card's L2
(50 MB on an H100), where a chain of matvecs is served from the cache and
reads above the HBM bound. So each timed matvec follows a write of
FLUSH_BYTES, which evicts them, and its time is the card's own: under
torch.profiler, the durations of the device work launched inside the
matvec (each activity matched to its launch call by correlation id, as
kktbench/spans.py does), not the host's launch path. The reading is the
median of REPS such matvecs. `chain_seconds`, a chain of dependent
matvecs on CUDA events (kktbench/yardstick.py), the host's pace, is kept
for the record."""
import statistics

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from kktbench import trace as T
from kktbench import yardstick

REPS = 30
FLUSH_BYTES = 512 * 2**20
SPAN = "kktbench.aij_matvec"


def aij_bytes(itemsize, nnz, n_rows):
    """Bytes one matvec of n_rows rows and nnz entries must move."""
    return itemsize * (nnz + 2 * n_rows)


def cold_seconds(step, x, flush, dev):
    """Device seconds of step(x) from HBM: the median over REPS of the
    summed durations of the device work launched inside one step, each
    step after a write of `flush`; None without device activity."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            with record_function(SPAN):
                step(x)
        torch.cuda.synchronize(dev)
    ranges, launch_at, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        s = T._start_ns(e)
        if T._on_device(e):
            if not T._annotation(e):
                device.append((e.correlation_id(), T._dur_ns(e)))
        elif e.name() == SPAN:
            ranges.append((s, s + T._dur_ns(e)))
        elif e.name().startswith("cu") and e.correlation_id():  # a runtime or driver call
            launch_at[e.correlation_id()] = s
    per = [0] * len(ranges)
    for corr, dur in device:
        t = launch_at.get(corr)
        for i, (lo, hi) in enumerate(ranges):
            if t is not None and lo <= t <= hi:
                per[i] += dur
    if not any(per):
        return None
    return statistics.median(per) / 1e9


def probe(run):
    """Device seconds per matvec of this rank's operator, its bytes, and
    the host-paced chain's seconds per matvec."""
    if run.state is None or run.dev.type != "cuda":
        return None
    A = run.state[0]
    if not hasattr(A, "matvec") or not hasattr(A, "to_scipy_rows"):
        return None
    lo = A.mesh.rank * A.n_loc
    n_rows = max(min(A.n_loc, A.shape[0] - lo), 0)
    nnz = int(A.to_scipy_rows().indptr[n_rows])
    # the chain's values grow with each product and may reach inf in
    # float32; the card's time for a product does not depend on them
    x = A.diag_vals_t.new_full((A.n_loc_c,), 1e-3)
    A.matvec(x)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=run.dev)
    dt = cold_seconds(A.matvec, x, flush, run.dev)
    del flush
    if dt is None:
        return None
    return {"seconds": dt, "bytes": aij_bytes(A.diag_vals_t.element_size(), nnz, n_rows),
            "chain_seconds": yardstick.chain_rate(A.matvec, x, 50, run.dev)}


def read(rec):
    p = rec["probes"].get("aij_matvec_roofline")
    bw = yardstick.peak(rec["device_kind"], "hbm_bytes_per_s")
    if not p or not bw or rec["world"] != 1:
        return None
    return 100.0 * p["bytes"] / bw / p["seconds"]
