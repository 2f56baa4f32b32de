"""Mesh specs for the trainer (``sd_video_gen_tpu/parallel/mesh.py`` mapped
onto ``torch.distributed``).

The JAX package builds one ``jax.sharding.Mesh`` with named axes ``data``
(batch-parallel) and ``model`` (tensor-parallel) over every device of every
host. torch runs one process per device, so the port's mesh is the process
group: ``data`` is the number of processes, and ``model`` is 1. Nothing is
built here: these functions check a spec and a batch against the group and
return the axes. A spec with ``model > 1`` asks for the tensor-parallel
rules, which are not ported yet, and raises ``NotImplementedError``; a
``data`` axis other than the process count raises a ``ValueError`` (start
one process per device).
"""

from __future__ import annotations

from sd_video_gen_tpu_torch.config import MULTI_DEVICE, not_ported
from sd_video_gen_tpu_torch.parallel.multihost import process_count

AXIS_DATA = "data"
AXIS_MODEL = "model"


def parse_mesh_spec(spec: str | None,
                    n_devices: int | None = None) -> dict[str, int]:
    """'data=4,model=1' -> {'data': 4, 'model': 1}; None -> every process on
    data. ``n_devices`` defaults to the process count."""
    n = n_devices if n_devices is not None else process_count()
    if not spec:
        return {AXIS_DATA: n, AXIS_MODEL: 1}
    out: dict[str, int] = {}
    for part in spec.split(","):
        k, v = part.split("=")
        k = k.strip()
        if k not in (AXIS_DATA, AXIS_MODEL):
            # a typo'd axis would otherwise silently fall back to model=1
            # (pure data parallelism) whenever the remaining product
            # matches the device count
            raise ValueError(
                f"unknown mesh axis '{k}' in spec '{spec}' — valid axes: "
                f"{AXIS_DATA}, {AXIS_MODEL}")
        out[k] = int(v)
    out.setdefault(AXIS_DATA, 1)
    out.setdefault(AXIS_MODEL, 1)
    if out[AXIS_MODEL] > 1:
        # before the device count: data=1,model=2 on one process is refused
        # for what it asks, not for the count
        not_ported(f"--mesh {spec}", MULTI_DEVICE)
    total = out[AXIS_DATA] * out[AXIS_MODEL]
    if total != n:
        raise ValueError(
            f"mesh spec {spec} needs {total} devices, have {n}: the port "
            f"runs one process per device (start {total} with torchrun, or "
            f"with --multihost --num_processes {total})")
    return out


def default_mesh_for_batch(batch_size: int,
                           n_devices: int | None = None) -> dict[str, int]:
    """Every process on the data axis. The global batch must divide evenly
    over them: each process takes an equal slice of every batch (the JAX
    package's multi-host rule; one process is one device here, so no device
    can idle)."""
    n = n_devices if n_devices is not None else process_count()
    if batch_size % n:
        raise ValueError(
            f"global batch_size {batch_size} must be divisible by the {n} "
            f"processes (one per device): set BATCH_SIZE to a multiple of "
            f"{n}")
    return {AXIS_DATA: n, AXIS_MODEL: 1}
