"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``build/kernels/`` at the repository root (git-ignored) under a name that
hashes the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time: the CPU
test suite imports every module without ``nvcc``.

``LAUNCHES`` counts kernel launches by name. Each wrapper calls
``count_launch`` where it launches its kernel and nowhere else, so a run can
show which kernels its main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

LAUNCHES: collections.Counter = collections.Counter()
BUILD = {"seconds": 0.0, "path": None}   # nvcc time (0 if already built)

_LIB = None
_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Compile csrc/*.cu unless a library of the same sources exists."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libsdvg_kernels_{digest}.so"
    BUILD["path"] = str(out)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD["seconds"] = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sdvg_flash_attention.argtypes = [p, p, p, p, i, i, i,
                                                 ctypes.c_float, i, p]
            lib.sdvg_flash_attention.restype = i
            lib.sdvg_error_string.argtypes = [i]
            lib.sdvg_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().sdvg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
