"""The constrained Q1 KKT problem of BASELINE configs 4 and 5, as the
harness needs it: the program's assembly on the `-dist` route, a load's
right-hand side, the answer a solve hands back, and the check against the
plain reference (kktbench/reference/q1kkt.py).

A configuration names its problem (`"problem": "q1kkt"`); the harness
finds this file by that name (kktbench/cells.py), so a problem of another
kind is a new file beside this one.
"""
from __future__ import annotations

import torch

from kktbench.reference.q1kkt import Reference
from saddle_point_petsc_tpu_torch.parallel import dist as pdist

# the compared numbers the check can give (a configuration's `limits` pick)
NUMBERS = ("resid", "resid_smooth", "constraint")


def assemble(n, mesh, dtype):
    """The program's KKT operator of an n x n node grid on `mesh`."""
    grid = pdist.DistGrid.create(n - 1, n - 1, mesh)
    K, _, _ = pdist.assemble_saddle_dist(grid, dtype=dtype, body_force="trig")
    return K


def rhs(loads, key, K, dtype, device):
    """(f, g): this rank's velocity load patch and the constraints' g."""
    f = loads.field(key, 2, K.A.origin, K.A.local_shape, dtype, device)
    return f, torch.full((4,), loads.g, dtype=dtype, device=device)


def answer(res):
    """The solve's answer as (this rank's patch, what every rank holds):
    the velocity patch (2, my, mx) and the four multipliers."""
    return res.x[0], res.x[1]


class Check:
    """The reference of an n x n grid in float64 on `device`."""

    def __init__(self, n, device):
        self.ref = Reference(n, device=device)

    def numbers(self, u, lam, loads, key):
        """The compared numbers of the whole-grid answer (u, lam) to the
        load `key`."""
        f = loads.field(key, 2, (0, 0), (self.ref.n, self.ref.n), torch.float64, self.ref.device)
        g = torch.full((4,), loads.g, dtype=torch.float64, device=self.ref.device)
        return self.ref.residuals(u, lam, f, g, loads.modes)
