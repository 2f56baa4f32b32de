"""Multi-process initialisation and the collectives of data-parallel
training (``sd_video_gen_tpu/parallel/multihost.py`` mapped onto
``torch.distributed``).

JAX runs one SPMD program over every device of every host, and XLA inserts
the gradient reduction. torch runs one process per device: ``initialize``
joins this process to the group (NCCL on the card, gloo on the CPU), each
process keeps its own slice of every global batch on its own device
(``global_batch_from_local``), and the trainer averages the gradients across
processes after the backward pass (``all_reduce_mean``). With equal local
batches that average is the global batch's mean gradient, the one JAX takes.

``COLLECTIVES`` counts ``all_reduce_mean`` calls by name in this process, so
a run can show how often it reduced. The all-reduce runs on the device
without a host sync (a flat buffer per dtype, the collective, the division
in place), so a compiled step over an NCCL group holds it in its graph
(``utils/jit.py``), which then adds its count once per replay.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES: collections.Counter = collections.Counter()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def local_rank(rank: int | None = None) -> int:
    """The card of rank ``rank`` (this process's by default) on its host:
    torchrun's ``LOCAL_RANK``, else the rank modulo the host's card count
    (ranks numbered host by host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(1, torch.cuda.device_count())


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               backend: str | None = None) -> None:
    """Join the process group: ``coordinator_address`` ``host:port`` of
    rank 0, the number of processes and this one's rank; where an argument
    is None, torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) gives it. ``device`` is the device the run
    asked for (None: the card): NCCL on the card, after this process takes
    its card; gloo on the CPU. ``backend`` names another backend where the
    caller needs one (gloo between processes that share one card, which
    NCCL refuses). A no-op if a group already exists."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [flag for flag, v in (("--coordinator", coordinator_address),
                                    ("--num_processes", num_processes),
                                    ("--process_id", process_id))
               if v is None]
    if missing:
        raise ValueError(f"a multi-process run needs {', '.join(missing)}: "
                         f"pass the flags, or start the processes with "
                         f"torchrun")
    if torch.device(device or "cuda").type == "cuda":
        backend = backend or "nccl"
        torch.cuda.set_device(local_rank(process_id))
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def rank_device(device: torch.device) -> torch.device:
    """The device this process computes on: inside a process group, a card
    asked for without an index is this rank's own card."""
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return device


def global_batch_from_local(local_batch, device) -> torch.Tensor:
    """This process's slice of the global batch (what its loader yields, with
    ``process_shard``) on this process's device. In JAX the slices of every
    process assemble into one global array; here each process computes on
    its own slice and the gradients meet in ``all_reduce_mean``."""
    return torch.as_tensor(np.asarray(local_batch)).to(device)


def all_reduce_mean(tensors, name: str, group=None) -> None:
    """Replace each tensor of ``tensors`` (in place) by its mean over the
    processes of ``group`` (default: all): one flat buffer per dtype,
    summed by one all-reduce, divided by the group's size. Counted under
    ``name``."""
    _all_reduce(tensors, name, group, mean=True)


def all_reduce_sum(tensors, name: str, group=None) -> None:
    """``all_reduce_mean`` without the division: the sum over ``group``."""
    _all_reduce(tensors, name, group, mean=False)


def _all_reduce(tensors, name: str, group, mean: bool) -> None:
    COLLECTIVES[name] += 1
    world = dist.get_world_size(group)
    by_dtype: dict = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for parts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if mean:
            flat.div_(world)
        for t, part in zip(parts, flat.split([t.numel() for t in parts])):
            t.copy_(part.view_as(t))


def gather_to_coordinator(obj):
    """Every process's ``obj`` (picklable) in rank order on rank 0, None on
    the others; ``[obj]`` without a group."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if is_coordinator() else None
    dist.gather_object(obj, out, dst=0)
    return out


def barrier() -> None:
    """Wait for every process of the group (none: return)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
