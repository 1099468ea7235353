"""One rank of a benchmark run: the program under test driven through its
library API (the calls the port's CLI makes), the measured window, the
traced units, and the check against the plain reference.

Every cell runs the port's `-dist` route: its problem's assembly
(`assemble_saddle_dist` for the KKT cells, kktbench/problems/) on a
`ProcessMesh`, `KSP(opts).set_operators(K).set_from_options()`,
`KSP.set_up()`, `KSP.solve((f, g))`. One card is a world of one over NCCL;
four are a 2 x 2 world, one process a card (kktbench/run.py starts them).
"""
from __future__ import annotations

import collections
import datetime
import gc
import math
import statistics
import subprocess
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from kktbench import loads as L
from kktbench import trace as T
from saddle_point_petsc_tpu_torch.parallel.mesh import ProcessMesh
from saddle_point_petsc_tpu_torch.solvers.ksp import KSP
from saddle_point_petsc_tpu_torch.utils.options import Options

DTYPES = {"float64": torch.float64, "float32": torch.float32}
TIMEOUT = datetime.timedelta(seconds=300)


def init_world(rank, world, store_path, dev):
    """The process group of the run: NCCL on the cards, gloo on the CPU,
    meeting at a FileStore."""
    kw = {"store": dist.FileStore(store_path, world), "rank": rank, "world_size": world, "timeout": TIMEOUT}
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)


class Program:
    """The system under test, as one configuration states it, on the
    problem that the configuration names."""

    def __init__(self, config, problem, mesh):
        self.n = int(config["grid_nodes"])
        self.dtype = DTYPES[config["dtype"]]
        self.options = list(config["options"])
        self.problem = problem
        self.mesh = mesh
        # no TF32 in float32 products, as the CLI sets it: assembly cancels
        # O(1) coordinates down to O(h) entries
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def assemble(self):
        return self.problem.assemble(self.n, self.mesh, self.dtype)

    def set_up(self, K):
        return KSP(Options(self.options)).set_operators(K).set_from_options().set_up()


class Run:
    """One rank's run of a cell, or of one of its configuration's controls
    (`control`, a key of its `controls`)."""

    def __init__(self, cell, seed, rank, world, dev, control=None):
        config = dict(cell.config)
        if control is not None:
            config.update(config["controls"][control])
        self.cell, self.config, self.seed = cell, config, seed
        self.rank, self.world, self.dev = rank, world, dev
        self.n = int(config["grid_nodes"])
        self.problem = cell.problem
        self.mesh = ProcessMesh.create(ny=self.n, nx=self.n, device=dev)
        self.program = Program(config, cell.problem, self.mesh)
        self.loads = L.Loads(cell.traffic, self.n, seed)
        self.rebuild = cell.traffic["rebuild"] == "every_unit"
        self.state = None  # (K, ksp) of the latest unit
        self.pool = []  # host buffers for the sampled answers
        self.reset()

    # ---- bookkeeping -------------------------------------------------
    def reset(self):
        self.spans = collections.defaultdict(list)
        self.its = []
        self.failed = 0
        self.samples = []

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def span(self, name, fn):
        """fn() on the host clock, ending in a synchronise."""
        with record_function("kktbench." + name):
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            self.spans[name].append(time.perf_counter() - t0)
        return out

    def agree(self, flag):
        """Rank 0's flag, on every rank."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.dev)
        dist.broadcast(t, 0)
        return bool(t.item())

    def reduce(self, value, op):
        """`value` reduced over the ranks (float64)."""
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.dev)
        dist.all_reduce(t, op=op)
        return t.item()

    # ---- the program -------------------------------------------------
    def build(self):
        self.state = None  # the previous unit's system is dropped first
        K = self.span("assemble", self.program.assemble)
        self.state = (K, self.span("pcsetup", lambda: self.program.set_up(K)))

    def unit(self, key):
        """One unit of the traffic: (a new system, when the mix rebuilds,
        then) a fresh load and its solve."""
        with record_function(T.UNIT):
            if self.rebuild or self.state is None:
                self.build()
            K, ksp = self.state
            b = self.span("load", lambda: self.problem.rhs(self.loads, key, K, self.program.dtype, self.dev))
            res = self.span("solve", lambda: ksp.solve(b))
        self.its.append(int(res.iterations))
        if res.converged_reason <= 0:
            self.failed += 1
        return res

    def buffers(self, res, count):
        """`count` sets of host buffers shaped as the answer of `res`,
        pinned on a card, so that a copy into them does not hold the host."""
        pin = self.dev.type == "cuda"
        self.pool = [tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=pin) for x in self.problem.answer(res))
                     for _ in range(count)]

    def keep(self, key, res):
        """The answer of `res` copied into the next free host buffers, in
        the card's stream order and without waiting for it (the check
        synchronises first); False when every buffer is taken."""
        if len(self.samples) >= len(self.pool):
            return False
        bufs = self.pool[len(self.samples)]
        for buf, x in zip(bufs, self.problem.answer(res)):
            buf.copy_(x, non_blocking=True)
        self.samples.append((key, bufs))
        return True

    def window(self, seconds, stride):
        """Units until `seconds` have passed on rank 0's clock; the answers
        of units 0 and offset + k * stride (offset drawn from the seed) are
        kept for the check while host buffers last. Returns (seconds,
        units)."""
        offset = L.offset(self.seed, stride)
        t0 = time.perf_counter()
        i = 0
        while True:
            res = self.unit((L.WINDOW, i))
            if i == 0 or i % stride == offset:
                self.keep((L.WINDOW, i), res)
            del res
            i += 1
            if self.agree(time.perf_counter() - t0 >= seconds):
                return time.perf_counter() - t0, i

    def traced(self, units):
        """`units` more units under torch.profiler (their answers are not
        copied: the window's are checked); the trace's summary."""
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for k in range(units):
                self.unit((L.TRACED, k))
            self.sync()
        return T.summarize(prof)

    def free(self):
        self.state = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ---------------------------------------------------
    def gathered(self, u):
        """The global field on rank 0 from every rank's patch u (None on
        the other ranks)."""
        if self.world > 1:
            t = u.to(self.dev)
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t)
            if self.rank:
                return None
            px = self.mesh.px
            u = torch.cat([torch.cat(parts[j * px : (j + 1) * px], dim=-1) for j in range(self.mesh.py)], dim=-2)
        return u[..., : self.n, : self.n]

    def check(self, samples):
        """The worst of each compared number (the problem's reference
        residuals) over the sampled answers, in float64 on rank 0 (None
        elsewhere). NaN reads inf, and so does a run with nothing to
        check."""
        self.sync()  # the copies into the host buffers are done
        ref = self.problem.Check(self.n, self.dev) if self.rank == 0 else None
        worst = {}
        for key, (patch, *rest) in samples:
            whole = self.gathered(patch)
            if ref is None:
                continue
            for k, v in ref.numbers(whole, *rest, self.loads, key).items():
                worst[k] = max(worst.get(k, 0.0), math.inf if math.isnan(v) else v)
        del ref
        if self.rank:
            return None
        return worst or dict.fromkeys(self.problem.NUMBERS, math.inf)

    # ---- a whole run -------------------------------------------------
    def prepare(self, warm, samples):
        """Set-up: the system (when the mix keeps it), `warm` units of
        warm-up, which touch every shape the window uses, and host buffers
        for `samples` answers. Returns the seconds of each step."""
        steps = {}
        t = time.perf_counter()
        if not self.rebuild:
            self.build()
            self.sync()
            steps["system"], t = time.perf_counter() - t, time.perf_counter()
        for k in range(warm):
            res = self.unit((L.WARM, k))
        self.sync()
        steps["warm"], t = time.perf_counter() - t, time.perf_counter()
        self.buffers(res, samples)
        steps["buffers"] = time.perf_counter() - t
        self.reset()
        return steps

    def measure(self, seconds, trace, t_start, steps):
        """The run of the cell; rank 0 returns its record and checks.
        `steps`: the seconds of set-up so far, by step."""
        traffic = self.cell.traffic
        steps.update(self.prepare(int(traffic["warm_units"]), int(traffic["check_samples"])))
        setup_s = time.time() - t_start
        window_s, units = self.window(seconds, int(traffic["check_stride"]))
        peak = self.reduce(float(torch.cuda.max_memory_allocated(self.dev)) if self.dev.type == "cuda" else 0.0,
                           dist.ReduceOp.MAX)
        rec = {"rebuild": traffic["rebuild"], "setup_s": setup_s, "setup_steps": steps, "window_s": window_s,
               "units": units, "failed": self.failed, "peak_bytes": peak, "world": self.world,
               "spans": dict(self.spans), "its": list(self.its), "trace": None, "probes": {},
               "platform": "gpu" if self.dev.type == "cuda" else "cpu",
               "device_kind": torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda" else "cpu"}
        samples, unconverged = self.samples, self.failed
        if trace:
            self.reset()
            rec["trace"] = self.traced(int(traffic["trace_units"]))
            unconverged += self.failed
            rec["busy_s"] = self.reduce(rec["trace"]["busy_s"] if rec["trace"] else 0.0, dist.ReduceOp.SUM) / self.world
            for m in self.cell.metrics:
                if not m.end_to_end and hasattr(m.reader, "probe"):
                    rec["probes"][m.name] = m.reader.probe(self)
        self.free()
        worst = self.check(samples)
        if self.rank:
            return None
        # each compared number that the configuration gives a limit
        values = {**worst, "unconverged": unconverged}
        rec["checks"] = {k: (values[k], lim) for k, lim in self.config["limits"].items()}
        rec["checked"] = len(samples)
        return rec

    def readings(self, seed, units):
        """The compared numbers over `units` units of seed `seed`, every
        one checked (the calibration of the limits; the host buffers have
        to hold `units` answers): rank 0 returns {number: worst reading}
        with `unconverged` and the mean, least and most iterations (`its`,
        `its_min`, `its_max`)."""
        self.seed, self.loads = seed, L.Loads(self.cell.traffic, self.n, seed)
        self.reset()
        for i in range(units):
            if not self.keep((L.WINDOW, i), self.unit((L.WINDOW, i))):
                raise ValueError(f"host buffers for {len(self.pool)} answers, not {units}")
        its = (statistics.fmean(self.its), min(self.its), max(self.its))
        failed, samples = self.failed, self.samples
        self.samples = []
        worst = self.check(samples)
        if self.rank:
            return None
        return {**worst, "unconverged": failed, "its": its[0], "its_min": its[1], "its_max": its[2]}


def power_line(dev):
    """The card's name and power limit, as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={dev.index}"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()
