"""Halo (ghost) exchange over torch.distributed point-to-point operations
(PyTorch twin of `saddle_point_petsc_tpu.parallel.halo`).

The stencil-width-1 box ghost region of a DMDA and its two transfer
directions:

- `halo_exchange` / `halo_exchange_1phase`: fill the ghosts with the
  neighbours' values (DMGlobalToLocal), before a stencil matvec;
- `halo_add`: fold ghost contributions back onto their owners
  (DMLocalToGlobal with ADD_VALUES), after element assembly.

The spatial dims are the LAST two axes of a patch (..., my, mx), as in
the dof-major field (2, my, mx) and the planes (4, 3, 3, my, mx). Ghosts
past the global boundary are zero. The JAX package's `lax.ppermute`
becomes one `dist.batch_isend_irecv` per phase: every rank posts its
sends and receives for each neighbour that exists, in one fixed order of
directions, so both sides of a pair match. Patches have equal shapes (the
grid is padded to divide the mesh), so what a rank receives from a
neighbour is shaped like what it sends there. Edges are made contiguous
before a send; receives land in fresh contiguous buffers. Works on CPU
tensors over gloo and CUDA tensors over NCCL, never CUDA tensors over
gloo.

Every send posted adds 1 to `halo.messages` and its bytes to `halo.bytes`
in `utils.monitor.counters` (none in a world of one, which has no
neighbour). The exchanges run under the span `HaloExchange` (the posting
of the overlap form only with more than one rank), the fold under
`HaloAdd` (utils/monitor.py).

`halo_add_df` (the f32-pair fold) is not ported: the port assembles in
f64.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from saddle_point_petsc_tpu_torch.utils import monitor

# the eight box directions (dj, di), in the one order every rank posts them
DIRECTIONS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
# the slice of a patch that faces direction -1, 0 or +1 along an axis
_FACE = {-1: slice(0, 1), 0: slice(None), 1: slice(-1, None)}


def _face(x, d):
    """The edge (or corner) of patch x facing direction d = (dj, di)."""
    return x[..., _FACE[d[0]], _FACE[d[1]]].contiguous()


@dataclasses.dataclass
class PendingHalo:
    """Exchanges in flight: `wait()` returns {direction: received tensor}
    for every neighbour that exists (absent ones are zero ghosts)."""

    works: list
    ghosts: dict

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = []
        return self.ghosts


def _swap_start(mesh, sends):
    """Post, as one batch, the send of sends[d]() to the neighbour at each
    direction d and a receive of the same shape from it. Absent neighbours
    are skipped, their slab never made (an empty batch posts nothing)."""
    ops, ghosts = [], {}
    for d, make in sends.items():
        peer = mesh.peer(*d)
        if peer is None:
            continue
        t = make()
        monitor.count("halo.messages")
        monitor.count("halo.bytes", t.nbytes)
        buf = torch.empty_like(t)
        ghosts[d] = buf
        ops.append(dist.P2POp(dist.isend, t, peer, group=mesh.group))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return PendingHalo(list(works), ghosts)


def _swap(mesh, sends):
    return _swap_start(mesh, sends).wait()


def pad_with_ghosts(x, ghosts):
    """(..., my, mx) patch plus {direction: ghost} -> (..., my+2, mx+2),
    zero where a direction has no ghost."""
    my, mx = x.shape[-2:]
    xp = x.new_zeros((*x.shape[:-2], my + 2, mx + 2))
    xp[..., 1:-1, 1:-1] = x  # in place: xp is the fresh buffer made above
    rows = {-1: slice(0, 1), 0: slice(1, my + 1), 1: slice(my + 1, my + 2)}
    cols = {-1: slice(0, 1), 0: slice(1, mx + 1), 1: slice(mx + 1, mx + 2)}
    for (dj, di), g in ghosts.items():
        xp[..., rows[dj], cols[di]] = g
    return xp


def halo_exchange(x, mesh):
    """Pad a (..., my, mx) patch with a 1-ring of neighbour values, in two
    phases: x (the last axis), then y with the new ghost columns, so the
    corners ride along. Returns (..., my+2, mx+2)."""
    with monitor.span("HaloExchange"):
        g = _swap(mesh, {d: lambda d=d: _face(x, d) for d in ((0, -1), (0, 1))})
        xw = pad_with_ghosts(x, g)[..., 1:-1, :]
        g = _swap(mesh, {d: lambda d=d: _face(xw, d) for d in ((-1, 0), (1, 0))})
        return pad_with_ghosts(xw, g)[..., :, 1:-1]


def halo_exchange_1phase_start(x, mesh) -> PendingHalo:
    """Post the single-phase box exchange: the 4 edges and 4 corners of x
    to the 8 neighbours, concurrently, as one batch. The caller may launch
    work on x before `wait()` (the overlap form of the distributed
    matvec). It runs under `HaloExchange` where the mesh has more than one
    rank; in a world of one it posts nothing."""
    if mesh.size == 1:
        return _post_box(x, mesh)
    with monitor.span("HaloExchange"):
        return _post_box(x, mesh)


def _post_box(x, mesh):
    return _swap_start(mesh, {d: lambda d=d: _face(x, d) for d in DIRECTIONS})


def halo_exchange_1phase(x, mesh):
    """The production exchange: the same padded patch as `halo_exchange`
    from one communication phase instead of two. In a world of one it
    still copies x into a fresh padded patch."""
    with monitor.span("HaloExchange"):
        return pad_with_ghosts(x, _post_box(x, mesh).wait())


def halo_add(xp, mesh):
    """Adjoint of `halo_exchange`: fold the ghost ring of a padded
    (..., my+2, mx+2) patch onto its owners; returns the owned
    (..., my, mx) patch. Two phases in reverse order (y, then x), so
    corner contributions route through the edge ghosts."""
    with monitor.span("HaloAdd"):
        g = _swap(mesh, {(1, 0): lambda: xp[..., -1:, :].contiguous(), (-1, 0): lambda: xp[..., :1, :].contiguous()})
        xw = xp[..., 1:-1, :].clone()
        # in place: xw is the copy made above
        if (-1, 0) in g:
            xw[..., :1, :] += g[(-1, 0)]
        if (1, 0) in g:
            xw[..., -1:, :] += g[(1, 0)]
        g = _swap(mesh, {(0, 1): lambda: xw[..., :, -1:].contiguous(), (0, -1): lambda: xw[..., :, :1].contiguous()})
        x = xw[..., :, 1:-1].clone()
        # in place: x is the copy made above
        if (0, -1) in g:
            x[..., :, :1] += g[(0, -1)]
        if (0, 1) in g:
            x[..., :, -1:] += g[(0, 1)]
        return x
