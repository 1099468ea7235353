"""The port's native sources, and how one of them is compiled.

`CSRC` is this directory: the CUDA kernels (`*.cu`, built by
ops/cuda/_build.py) and the host library `native_host.cpp` (built by
utils/native.py). Both build into `_build/` here (ignored by git) through
`compile_once`: a build runs under its own fcntl lock into a temporary
name and is moved into place with os.replace, so parallel processes do
not race. Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC / "_build"


def compile_once(name, out, command):
    """Run `command(tmp_path)` (a compiler writing tmp_path) under the lock
    `_build/<name>.lock` and move the result to `out`, unless another
    process already has; returns (command line, compiler output), () and ""
    when `out` was there."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return (), ""
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = tuple(command(str(tmp)))
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}{proc.stdout}"
                )
            os.replace(tmp, out)
            return cmd, proc.stderr + proc.stdout
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
