"""Build and load the package's CUDA kernels.

At first use, `load_library()` compiles `csrc/stencil_spmv.cu` with nvcc
into a shared library with a plain C interface and loads it with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <out> csrc/stencil_spmv.cu

The output goes to `csrc/_build/` inside the package (ignored by git),
named by a hash of the source text and the flags, so a stale build is
never loaded. The build runs under an fcntl lock into a temporary name
and is moved into place with os.replace, so parallel processes do not
race. Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCE = CSRC / "stencil_spmv.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """How the loaded library came to be (printed by chip_smoke.py)."""

    path: str
    command: tuple  # the nvcc command line, () when an existing build was loaded
    log: str  # nvcc's output (ptxas register/spill report)
    seconds: float  # wall time of the build and load


_lib = None
_info = None


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


def _library_path():
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libstencil_spmv_{digest}.so"


def _compile(out):
    """Compile SOURCE into `out` unless another process already has."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return (), ""
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = (find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE))
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}{proc.stdout}"
                )
            os.replace(tmp, out)
            return cmd, proc.stderr + proc.stdout
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_library():
    """Build (if needed) and load the kernel library; returns the ctypes CDLL."""
    global _lib, _info
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    out = _library_path()
    cmd, log = _compile(out) if not out.exists() else ((), "")
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("stencil_spmv_f32", "stencil_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
        fn.restype = i32
    lib.stencil_spmv_error_string.argtypes = [i32]
    lib.stencil_spmv_error_string.restype = ctypes.c_char_p
    _info = BuildInfo(str(out), cmd, log, time.perf_counter() - t0)
    _lib = lib
    return lib


def build_info():
    """BuildInfo of the loaded library, or None before load_library()."""
    return _info
