"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``build/kernels/`` at the repository root (git-ignored) under a name that
hashes every file under ``csrc/`` (headers included) and the flags
(``source_digest``), so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import time: the CPU
test suite imports every module without ``nvcc``.

``LAUNCHES`` counts kernel launches by name. Each wrapper calls
``count_launch`` where it launches its kernel and nowhere else, so a run can
show which kernels its main path went through. ``CALLS`` counts dispatcher
calls by kernel name, kernel or plain version (``record``). A CUDA graph
replay runs no wrapper: ``utils/jit.py`` keeps the counts a capture saw
(``counters``: these, and the collectives and tensor-parallel routes a
sharded program counts) with its graph and adds them once per replay.

``force_reference`` sends every dispatcher of this package (``attention``,
``group_norm``) to its plain version at once: the on-card comparison of a
whole model with and without the kernels. ``record_calls`` lists the
signatures the dispatchers see, kernel or not: a dry run of a path under
``force_reference`` gives every shape the path hands each kernel.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

LAUNCHES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()
BUILD = {"seconds": 0.0, "path": None}   # nvcc time (0 if already built)

_LIB = None
_LOCK = threading.Lock()
_FORCE: list = []
_RECORDERS: list = []


def count_launch(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def counters() -> list:
    """Every host counter a compiled program's replay must move as its
    eager run would: ``LAUNCHES``, ``CALLS``, both dispatchers' launches by
    body, the all-reduces (``multihost.COLLECTIVES``) and the sharded
    attention's routes (``attention.TP_ROUTES``)."""
    from sd_video_gen_tpu_torch.ops import attention, groupnorm
    from sd_video_gen_tpu_torch.parallel import multihost
    return [LAUNCHES, CALLS, attention.ROUTE_LAUNCHES,
            groupnorm.ROUTE_LAUNCHES, multihost.COLLECTIVES,
            attention.TP_ROUTES]


class force_reference:
    """Context manager sending every kernel dispatch in this process to the
    plain version."""

    def __enter__(self):
        _FORCE.append("reference")
        return self

    def __exit__(self, *exc):
        _FORCE.pop()
        return False


def forced() -> bool:
    """True inside ``force_reference``."""
    return bool(_FORCE)


class record_calls:
    """Context manager counting, by (kernel name, call signature), the
    dispatcher calls made in this process while it is open (``.calls``)."""

    def __enter__(self):
        self.calls = collections.Counter()
        _RECORDERS.append(self.calls)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self.calls)
        return False


def recording() -> bool:
    """True inside ``record_calls``."""
    return bool(_RECORDERS)


def record(name: str, signature: tuple) -> None:
    """Called by each dispatcher for every call its kernel could take."""
    with _LOCK:
        CALLS[name] += 1
    for calls in _RECORDERS:
        calls[(name, signature)] += 1


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would have to pass through kernel ``name``: grad mode
    is on and one of ``tensors`` requires grad. The launchers write their
    result through a raw pointer, so it would come back without a ``grad_fn``
    and cut the graph without a word; neither kernel has a backward (as the
    TPU kernels have no ``custom_vjp``). Frozen callers run under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and grad mode is on, but the "
            f"kernel has no backward; call it under torch.no_grad() (a "
            f"frozen module) or differentiate the plain version")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def source_digest(csrc: Path = CSRC, flags=NVCC_FLAGS) -> str:
    """Hash of every file under ``csrc`` (name and bytes, any suffix: an
    edited header rebuilds too) and of the nvcc flags."""
    h = hashlib.sha256()
    for p in sorted(f for f in csrc.rglob("*") if f.is_file()):
        name = p.relative_to(csrc).as_posix().encode()
        h.update(len(name).to_bytes(8, "little") + name)
        data = p.read_bytes()
        h.update(len(data).to_bytes(8, "little") + data)
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu unless a library of the same sources exists."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = source_digest()
    out = BUILD_DIR / f"libsdvg_kernels_{digest}.so"
    BUILD["path"] = str(out)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{p.stem}.{digest}.{os.getpid()}.o")
            for p in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                             for p, o in zip(sources, objs))]
        logs = [p.communicate()[0] for p in procs]   # waits for every one
        _run_ok(procs, logs)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _run_ok([link], [link.stdout])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD["seconds"] = time.perf_counter() - t0
    return out


def _run_ok(procs, logs) -> None:
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(p.args)}\n{text}")


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
            lib.sdvg_flash_attention_wgmma.argtypes = [p, p, p, p, i, i, i,
                                                       ctypes.c_float, p]
            lib.sdvg_flash_attention_wgmma.restype = i
            lib.sdvg_flash_attention_tf32x3.argtypes = [p, p, p, p, i, i, i,
                                                        ctypes.c_float, p]
            lib.sdvg_flash_attention_tf32x3.restype = i
            ll = ctypes.c_longlong
            lib.sdvg_groupnorm_silu_workspace.argtypes = [i, i, ll, i]
            lib.sdvg_groupnorm_silu_workspace.restype = ll
            lib.sdvg_groupnorm_silu.argtypes = [p, p, p, p, p, i, i, ll, i,
                                                ctypes.c_float, i, i, p]
            lib.sdvg_groupnorm_silu.restype = i
            lib.sdvg_groupnorm_silu_nhwc_plan.argtypes = [
                i, i, ll, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
            lib.sdvg_groupnorm_silu_nhwc_plan.restype = ll
            lib.sdvg_groupnorm_silu_nhwc.argtypes = [
                p, p, p, p, p, ll, i, i, ll, i, ctypes.c_float, i, i, i, p]
            lib.sdvg_groupnorm_silu_nhwc.restype = i
            lib.sdvg_error_string.argtypes = [i]
            lib.sdvg_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().sdvg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
