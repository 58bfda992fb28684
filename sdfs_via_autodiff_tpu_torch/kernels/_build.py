"""Build the port's CUDA kernels from the sources in ``csrc/`` and load them.

At first use, ``nvcc`` compiles ``csrc/<name>.cu`` into a shared library
with a plain C interface under the package's ``_build/`` directory, keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, and ``ctypes`` loads it.  Importing a kernel module never builds:
only a launch on a CUDA tensor does, so the CPU tests need no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# Hopper only: sm_90a keeps wgmma/setmaxnreg available to later kernels.
# No --use_fast_math: expf/logf/log1pf stay correctly rounded to ~1 ulp.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels build from source")
    return path


def build(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu``, compiling it if
    no library of this source and these flags exists yet.  The compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside it as ``<library>.log``."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)      # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
