"""Build and load the package's CUDA kernels.

Each kernel source `csrc/<name>.cu` becomes its own shared library with a
plain C interface, compiled at first use with nvcc and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <out> csrc/<name>.cu

`load_library(name)` builds (if needed) and loads one library;
`build_all()` starts one nvcc for every source at once and waits for all.
The output goes to `csrc/_build/` inside the package (ignored by git),
named by the source's name and a hash of its text and the flags, so a
stale build is never loaded; `csrc.compile_once` runs each build under a
lock, so parallel processes do not race. Nothing is compiled or loaded
when this module is imported.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import threading
import time
from pathlib import Path

from saddle_point_petsc_tpu_torch.csrc import BUILD_DIR, CSRC, compile_once

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """How one loaded library came to be (printed by chip_smoke.py)."""

    name: str
    path: str
    command: tuple  # the nvcc command line, () when an existing build was loaded
    log: str  # nvcc's output (ptxas register/spill report)
    seconds: float  # wall time of the build and load


_libs = {}
_infos = {}
_mutex = threading.Lock()


def sources():
    """Names of the kernel sources, `csrc/<name>.cu`, sorted."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def find_nvcc():
    """nvcc on PATH, else under $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of saddle_point_petsc_tpu_torch need the CUDA toolkit"
    )


def _library_path(name):
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name, out):
    """Compile csrc/<name>.cu into `out` unless another process already has."""
    return compile_once(
        name, out, lambda tmp: (find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu"))
    )


def load_library(name):
    """Build (if needed) and load csrc/<name>.cu; returns the ctypes CDLL.

    Every library exports `<name>_error_string(int) -> const char*`; the
    wrapper module sets the argument types of its own entry points."""
    with _mutex:
        if name in _libs:
            return _libs[name]
    t0 = time.perf_counter()
    out = _library_path(name)
    cmd, log = _compile(name, out) if not out.exists() else ((), "")
    lib = ctypes.CDLL(str(out))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    with _mutex:
        _infos[name] = BuildInfo(name, str(out), cmd, log, time.perf_counter() - t0)
        return _libs.setdefault(name, lib)


def build_all(names=None):
    """Build and load every kernel library, one nvcc per source, all started
    together; returns {name: BuildInfo}. Raises if any build fails."""
    names = tuple(names or sources())
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for _ in pool.map(load_library, names):
            pass
    return {n: _infos[n] for n in names}


def build_info(name):
    """BuildInfo of a loaded library, or None before load_library(name)."""
    return _infos.get(name)


def check(lib, name, rc):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
