"""Process mesh for the distributed stencil path (PyTorch twin of
`saddle_point_petsc_tpu.parallel.mesh`).

The JAX package is single-controller: one process sees every device, the
Krylov code works on globally sharded arrays and XLA inserts the
reductions. The port is SPMD over processes, as `torchrun` launches them:
one rank per device patch. Each rank holds its (..., my, mx) patch of
every field on its own device; neighbour ghosts move by torch.distributed
point-to-point operations (parallel/halo.py) and every global reduction
is one all_reduce of the ranks' partial sums (`ProcessMesh.all_reduce`,
called by solvers/krylov.py's reductions and the distributed operators).
The row-partitioned matrix (parallel/dist_csr.py) lies on a (1, world)
mesh and ships its ghost entries with one all_to_all
(`ProcessMesh.all_to_all`). NCCL serves CUDA devices, gloo the CPU.

Rank r sits at mesh position (r // px, r % px). `torchrun` numbers ranks
host by host, so each host's ranks form contiguous mesh rows: the JAX
`make_mesh(hosts_major=True)` layout.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from saddle_point_petsc_tpu_torch.utils import monitor
from saddle_point_petsc_tpu_torch.utils.device import resolve_device

# every process group gets a timeout, so that a mismatched send or
# receive fails instead of hanging the run
TIMEOUT = datetime.timedelta(seconds=300)


def decide_process_grid(ndev, ny=None, nx=None):
    """Factor ndev into (py, px), preferring near-square patches.

    Equivalent of DMDACreate2d's PETSC_DECIDE factorization: pick
    py*px = ndev minimizing the patch aspect ratio for an (ny x nx)-node
    grid (square grid assumed if not given).
    """
    ny = ny or 1
    nx = nx or 1
    best = (1, ndev)
    best_cost = float("inf")
    for py in range(1, ndev + 1):
        if ndev % py:
            continue
        px = ndev // py
        # patch aspect cost: want (ny/py) / (nx/px) close to 1
        cost = abs(math.log((ny / py) / (nx / px))) if ny and nx else 0.0
        if cost < best_cost:
            best_cost = cost
            best = (py, px)
    return best


def init_from_env(device, timeout=TIMEOUT):
    """Join (or start) the process group for `device`; returns (device,
    created).

    Under `torchrun` (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT set) every rank joins the world through the env://
    rendezvous; without that environment the process starts a world of
    one through an in-process HashStore. A CUDA device without an index
    becomes cuda:LOCAL_RANK, set as the current device before the first
    collective. NCCL serves a CUDA device, gloo the CPU. An already
    initialized default group is reused (created = False); the caller
    that created the group destroys it (`dist.destroy_process_group`).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"timeout": timeout}
    if device.type == "cuda":
        kw["device_id"] = device
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return device, True


@dataclasses.dataclass
class PendingAllToAll:
    """An all_to_all in flight: `wait()` returns its output. On a CUDA
    device the wait orders the current stream after the exchange."""

    work: Any  # the torch.distributed work, None when nothing was sent
    out: torch.Tensor

    def wait(self):
        if self.work is not None:
            self.work.wait()
            self.work = None
        return self.out


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The (py, px) mesh of the world's ranks and this rank's place in it.

    Ranks are the default group's: rank = pj * px + pi. `device` holds this
    rank's patches.
    """

    py: int
    px: int
    pj: int
    pi: int
    device: torch.device
    group: Any = None  # the torch.distributed group; None = the default (world) group

    @staticmethod
    def create(shape=None, ny=None, nx=None, device=None):
        """The mesh over the initialized world; `shape` (py, px) defaults to
        `decide_process_grid` for an (ny x nx)-node grid. `device=None` is
        the card, as everywhere in the library API: the current CUDA
        device (cuda:LOCAL_RANK after `init_from_env`), raising without
        one; the CPU runs only when asked for (device="cpu")."""
        world, rank = dist.get_world_size(), dist.get_rank()
        py, px = shape if shape is not None else decide_process_grid(world, ny, nx)
        if py * px != world:
            raise ValueError(f"mesh {py}x{px} needs {py * px} ranks; the world has {world}")
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dist.get_backend() == "gloo":
                raise ValueError("gloo moves CPU tensors only: start the group on NCCL for the card "
                                 "(init_from_env) or pass device='cpu'")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        return ProcessMesh(py, px, rank // px, rank % px, dev)

    @property
    def shape(self):
        return (self.py, self.px)

    @property
    def size(self):
        return self.py * self.px

    @property
    def rank(self):
        return self.pj * self.px + self.pi

    def peer(self, dj, di):
        """The rank at mesh offset (dj, di) from this one, or None past the
        mesh's edge (non-periodic)."""
        j, i = self.pj + dj, self.pi + di
        if 0 <= j < self.py and 0 <= i < self.px:
            return j * self.px + i
        return None

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """Reduce `t` over the ranks by `op` (a sum by default), in place
        (one all_reduce, under the span `AllReduce`, counted in
        `all_reduce.calls` and `all_reduce.bytes`); returns t. A world of
        one is the identity and calls and counts no collective."""
        if self.size > 1:
            monitor.count("all_reduce.calls")
            monitor.count("all_reduce.bytes", t.nbytes)
            with monitor.span("AllReduce"):
                dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_to_all(self, inp, out=None, async_op=False):
        """Split inp's first dim into `size` equal chunks, send chunk r to
        rank r and receive rank s's chunk for this rank as chunk s of the
        output (one all_to_all_single with equal splits); inp contiguous.
        `out`: a contiguous buffer shaped like inp to receive into, else a
        fresh one. Returns the output, or with async_op a PendingAllToAll.
        A world of one is the identity (inp itself) and calls no
        collective. Counts the size - 1 messages to the other ranks and
        their bytes (`all_to_all.messages`, `all_to_all.bytes`)."""
        if self.size == 1:
            return PendingAllToAll(None, inp) if async_op else inp
        monitor.count("all_to_all.messages", self.size - 1)
        monitor.count("all_to_all.bytes", inp.nbytes // self.size * (self.size - 1))
        out = torch.empty_like(inp) if out is None else out
        work = dist.all_to_all_single(out, inp, group=self.group, async_op=async_op)
        return PendingAllToAll(work, out) if async_op else out

    def local_rows(self, x):
        """This rank's block of rows of the global array x (first dim
        divisible by the world size; ranks in order)."""
        n = x.shape[0] // self.size
        return x[self.rank * n : (self.rank + 1) * n]

    def global_rows_like(self, t):
        """A template of t's dtype, on t's device, shaped like the global
        array whose block of rows t is: one element broadcast to that shape,
        which holds no memory of its size (only its shape, dtype and device
        are read)."""
        return t.new_empty(()).expand(t.shape[0] * self.size, *t.shape[1:])

    def local_patch(self, x):
        """This rank's (..., my, mx) view of the global array x (grid dims
        last, each divisible by the mesh)."""
        my, mx = x.shape[-2] // self.py, x.shape[-1] // self.px
        return x[..., self.pj * my : (self.pj + 1) * my, self.pi * mx : (self.pi + 1) * mx]

    def global_like(self, t):
        """A template of t's dtype, on t's device, shaped like the global
        array whose patch t is (t's last two dims times (py, px)): one
        element broadcast to that shape, as `global_rows_like`."""
        return t.new_empty(()).expand(*t.shape[:-2], t.shape[-2] * self.py, t.shape[-1] * self.px)


def shard_field(x, mesh: ProcessMesh, dtype=None):
    """This rank's patch of the global array x (numpy or torch, grid dims
    last, each divisible by the mesh), as a contiguous tensor on the mesh's
    device. Setup and tests."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    p = mesh.local_patch(x)
    return p.to(device=mesh.device, dtype=dtype or p.dtype).contiguous()


def gather_field(x, mesh: ProcessMesh):
    """The global array from every rank's patch x (grid dims last): on rank
    0 a tensor on x's device, None on the others. Collective: every rank
    calls it. Setup, output and tests only."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    if mesh.rank != 0:
        return None
    rows = [torch.cat(parts[j * mesh.px : (j + 1) * mesh.px], dim=-1) for j in range(mesh.py)]
    return torch.cat(rows, dim=-2)


def gather_rows(x, mesh: ProcessMesh):
    """The global array from every rank's block of rows x (equal shapes,
    ranks in order), on every rank, on x's device. Collective: every rank
    calls it. Setup, output and tests only."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def all_gather_tiles(x, mesh: ProcessMesh, rows, cols):
    """The global array, on every rank, from the patches x of an unequal
    tiling (grid dims last): rank (pj, pi) holds the global rows
    rows[pj] = (lo, hi) and columns cols[pi], the ranges in order. One
    all_gather of the patches zero-padded to the largest; a world of one
    returns x."""
    if mesh.size == 1:
        return x
    hs = [hi - lo for lo, hi in rows]
    ws = [hi - lo for lo, hi in cols]
    buf = x.new_zeros((*x.shape[:-2], max(hs), max(ws)))
    buf[..., : x.shape[-2], : x.shape[-1]] = x  # in place: buf is the fresh buffer made above
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat([torch.cat([parts[j * mesh.px + i][..., : hs[j], : ws[i]] for i in range(mesh.px)], dim=-1)
                      for j in range(mesh.py)], dim=-2)
