"""The process layout (``sd_video_gen_tpu/parallel/mesh.py`` mapped onto
``torch.distributed``).

The JAX package builds one ``jax.sharding.Mesh`` with named axes ``data``
(batch-parallel) and ``model`` (tensor-parallel) over every device of every
host. torch runs one process per device, so the port's mesh is the process
group laid out as a ``data x model`` grid: rank ``r`` is data rank
``r // model`` and model rank ``r % model``, the order in which the JAX mesh
reshapes its device list (``np.reshape(devices, (data, model))``), so the
ranks of one model group are contiguous. ``make_layout`` checks a spec
against the group and creates the per-axis process groups: the ``model``
group of a rank holds the ranks that share its slice of every batch and
split its models (``parallel/sharding.py``, ``parallel/constrain.py``); its
``data`` group the ranks that hold the same shard of the models, over which
gradients and statistics are averaged. A spec whose axes do not multiply to
the process count raises a ``ValueError`` (start one process per device).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from sd_video_gen_tpu_torch.parallel.multihost import (process_count,
                                                       process_index)

AXIS_DATA = "data"
AXIS_MODEL = "model"


def parse_mesh_spec(spec: str | None,
                    n_devices: int | None = None) -> dict[str, int]:
    """'data=2,model=2' -> {'data': 2, 'model': 2}; None -> every process on
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


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This process's place on the ``model`` axis: rank ``rank`` of
    ``size``, whose collectives run over ``group``. The sharded modules
    carry it (``models/``)."""
    group: object
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Layout:
    """This process's place in the ``data x model`` grid, and the process
    groups of its two axes (``None`` where no collective runs over it:
    outside a process group, or an axis of 1 beside the other; without a
    model axis the data group is the whole group, of one process too)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object = None
    model_group: object = None

    @property
    def shard(self) -> ModelShard | None:
        """The model-axis handle the sharded modules take; ``None`` at
        ``model`` = 1, where every module is the plain one."""
        if self.model == 1:
            return None
        return ModelShard(self.model_group, self.model, self.model_rank)

    @property
    def groups(self) -> tuple:
        """The axis groups this process's collectives run over (none
        outside a process group)."""
        return tuple(g for g in (self.data_group, self.model_group)
                     if g is not None)

    def rows(self, n: int) -> tuple[int, int]:
        """This process's rows [lo, hi) of an ``n``-row global batch: the
        data ranks take contiguous slices in rank order, the first
        ``n % data`` one row more (a ragged batch still covers every
        row)."""
        base, extra = divmod(n, self.data)
        lo = self.data_rank * base + min(self.data_rank, extra)
        return lo, lo + base + (self.data_rank < extra)


_LAYOUTS: dict = {}


def make_layout(spec: str | None = None) -> Layout:
    """The layout of ``spec`` (``parse_mesh_spec``; None: every process on
    ``data``) over the current process group, with its axis groups created.
    Every process of the group must call it, in the same order as the
    others (``dist.new_group`` is collective); a second call with the same
    axes in the same group returns the first call's layout."""
    axes = parse_mesh_spec(spec)
    data, model = axes[AXIS_DATA], axes[AXIS_MODEL]
    rank = process_index()
    world = dist.group.WORLD if dist.is_initialized() else None
    key = (data, model, world)
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    data_group = model_group = None
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                model_group = g
    if model == 1:
        data_group = world
    elif data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                data_group = g
    layout = Layout(data, model, rank // model, rank % model, data_group,
                    model_group)
    _LAYOUTS[key] = layout
    return layout
