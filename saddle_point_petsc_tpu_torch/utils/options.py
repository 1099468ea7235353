"""PETSc-style options database, shared with the JAX package.

`saddle_point_petsc_tpu.utils.options` imports only the standard library
(and so does the JAX package's `__init__`), so the port re-exports it
rather than copying it. `tests/test_torch_cli.py` checks that importing
and running the port never brings `jax` into the process.
"""
from saddle_point_petsc_tpu.utils.options import Options, parse_argv  # noqa: F401
