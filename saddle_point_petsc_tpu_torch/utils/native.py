"""Native C++ host kernels (RCM ordering, greedy aggregation, ...), shared
with the JAX package.

`saddle_point_petsc_tpu.utils.native` imports only numpy, ctypes and the
standard library, and builds its library with g++ at first use, so the
port re-exports it rather than copying it. Every caller keeps a fallback
for when the library does not load.
"""
from saddle_point_petsc_tpu.utils.native import (  # noqa: F401
    NativeUnavailable,
    aggregate,
    available,
    rcm,
)
