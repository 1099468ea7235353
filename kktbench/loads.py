"""The one load generator: every traffic mix is a data file of parameters
that this module and the runner read (kktbench/traffic/<name>.json).

A load is smooth: for each velocity component c, the lowest `modes` x
`modes` sine modes of the unit square,

    f_c(x_i, y_j) = sum_{k,l=1..modes} a[c, l, k] sin(k pi x_i) sin(l pi y_j),

zero on the Dirichlet boundary and on padding nodes, with amplitudes
a = +-1 drawn from the run's seed and the load's key (every load puts the
same energy in each mode, so loads differ less in the iterations they
need). The problem (kktbench/problems/<name>.py) says how many components
a load has and what else its right-hand side holds (the traffic's
constant `g`). The same key gives the same load on every rank, to the
program in its own dtype and to the reference in float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# streams of keys: units of the measured window, warm-up units, traced units
WINDOW, WARM, TRACED = 0, 1, 2


def amplitudes(seed, key, components, modes):
    """(components, modes, modes) float64 amplitudes +-1 of the load `key`
    = (stream, index) under `seed` (any whole number)."""
    rng = np.random.default_rng([seed % 2**64, *key])
    return rng.choice((-1.0, 1.0), size=(components, modes, modes))


def offset(seed, stride):
    """Which of every `stride` units the check keeps, drawn from the seed."""
    return int(np.random.default_rng([seed % 2**64, 3]).integers(stride))


def _sines(modes, lo, count, n, device):
    """(modes, count) sin(k pi t / (n - 1)) at the nodes lo .. lo + count - 1,
    zero on the boundary nodes 0 and n - 1 and past the grid."""
    t = torch.arange(lo, lo + count, dtype=torch.float64, device=device)
    k = torch.arange(1, modes + 1, dtype=torch.float64, device=device)
    s = torch.sin(k[:, None] * t[None, :] * (math.pi / (n - 1)))
    inside = (t > 0) & (t < n - 1)
    return torch.where(inside[None, :], s, 0.0)


class Loads:
    """Loads of one traffic mix on an n x n node grid, for seed `seed`."""

    def __init__(self, traffic, n, seed):
        self.modes = int(traffic["modes"])
        self.g = float(traffic["g"])
        self.n = n
        self.seed = seed

    def field(self, key, components, origin, shape, dtype, device):
        """This rank's (components, my, mx) patch of the load `key` at
        `origin` in dtype on device (made in float64, then cast)."""
        (j0, i0), (my, mx) = origin, shape
        a = torch.tensor(amplitudes(self.seed, key, components, self.modes), device=device)
        sy = _sines(self.modes, j0, my, self.n, device)
        sx = _sines(self.modes, i0, mx, self.n, device)
        return torch.einsum("lj,clk,ki->cji", sy, a, sx).to(dtype).contiguous()
