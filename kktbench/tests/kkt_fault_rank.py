"""A run of the harness with a fault planted in the program underneath it,
for test_kktbench_faults.py: the fault named by KKT_FAULT is planted, then
kktbench/run.py's main runs with this file as the script of every other
rank, so each rank carries the fault.

    KKT_FAULT=<fault> python kktbench/tests/kkt_fault_rank.py <run.py arguments>

Faults: `unchanged` (the solve hands back its start, x0 = 0), `altered`
(the velocity answer of rank 0's patch negated where the solve produces
it), `no_exchange` (the halo exchange between ranks left out of every
matvec), `control:<name>` (the program run as the configuration's control
<name>: `control:rtol_1e-6` solves to a hundred times the stated rtol)."""
import dataclasses
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from saddle_point_petsc_tpu_torch.parallel import dist as pdist  # noqa: E402
from saddle_point_petsc_tpu_torch.solvers import ksp as kspmod  # noqa: E402


class _NoGhosts:
    def wait(self):
        return {}


def plant(fault):
    solve = kspmod.KSP.solve
    if fault.startswith("control:"):
        from kktbench import runner

        init = runner.Run.__init__

        def as_control(self, *args, control=None, **kw):
            init(self, *args, control=fault.split(":", 1)[1], **kw)

        runner.Run.__init__ = as_control
        return
    if fault == "unchanged":
        def broken(self, b, x0=None):
            res = solve(self, b, x0)
            return dataclasses.replace(res, x=tuple(torch.zeros_like(t) for t in res.x))
    elif fault == "altered":
        def broken(self, b, x0=None):
            res = solve(self, b, x0)
            if not torch.distributed.get_rank():
                res.x[0].neg_()  # in place: the answer as produced
            return res
    elif fault == "no_exchange":
        pdist.halo_exchange_1phase_start = lambda x, mesh: _NoGhosts()
        return
    else:
        raise ValueError(fault)
    kspmod.KSP.solve = broken


if __name__ == "__main__":
    plant(os.environ["KKT_FAULT"])
    from kktbench import run

    sys.exit(run.main(sys.argv[1:], script=__file__))
