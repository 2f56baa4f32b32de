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

A server across the group (``predict/serve.py``) takes each request from
rank 0 by ``broadcast`` (the group's own backend, outside the programs,
its wait bounded on the host), and runs inside ``end_group_on_failure``:
a failure on any rank ends every rank with exit code 1.

An entry point run in a group (the trainer's, predict's and the FVD CLI's
``main``) frees its compiled programs before it returns
(``releases_programs``): a CUDA graph that holds an NCCL collective keeps
that communicator from being destroyed (NCCL's destroy waits until every
such graph is gone), and an ``SDPipeline`` and its programs form a
reference cycle that only the cyclic collector frees. The group can then be
destroyed by whoever made it, or at exit.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import os
import sys
import threading
import time
import traceback

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


def _collective_device(group=None) -> torch.device:
    """Where ``group``'s backend takes its tensors: this rank's card for
    NCCL, the host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast(tensor: torch.Tensor, timeout_s: float | None = None,
              group=None) -> torch.Tensor:
    """Rank 0's ``tensor`` on every rank of ``group`` (default: all), each
    rank passing one of the same shape and dtype: a copy on the group's
    device (``_collective_device``), the input untouched. The host waits
    for it at most ``timeout_s`` seconds (None: without a bound) and
    raises ``TimeoutError`` after that: a rank waiting on a peer that will
    not send must not hang. Without a group, ``tensor`` itself."""
    if not dist.is_initialized():
        return tensor
    buf = tensor.to(_collective_device(group), copy=True)
    work = dist.broadcast(buf, src=0, group=group, async_op=True)
    if timeout_s is not None:
        end = time.monotonic() + timeout_s
        while not work.is_completed():
            if time.monotonic() > end:
                raise TimeoutError(f"no broadcast from rank 0 in "
                                   f"{timeout_s} s")
            time.sleep(1e-3)
    work.wait()
    return buf


def broadcast_ints(values, length: int, timeout_s: float | None = None,
                   group=None) -> list[int]:
    """Rank 0's ``values`` (at most ``length`` ints; the others pass None)
    on every rank, padded with 0 to ``length``: a small header, by
    ``broadcast``."""
    head = torch.zeros(length, dtype=torch.int64)
    if values is not None:
        head[:len(values)] = torch.tensor(list(values), dtype=torch.int64)
    return broadcast(head, timeout_s, group).cpu().tolist()


_ABORT_KEY = "sdvg/abort"


def _end(why: str) -> None:
    print(f"rank {process_index()}: {why}; ending this process",
          file=sys.stderr, flush=True)
    os._exit(1)


@contextlib.contextmanager
def end_group_on_failure(poll_s: float = 0.2):
    """Inside it, an exception on any rank ends every rank of the group
    with exit code 1. The failing rank marks the group's store and exits;
    a thread on every rank that finds the mark ends its process, wherever
    its main thread waits (a collective of a group that lost a rank never
    returns, and after a failed collective the communicator cannot be
    trusted). Both exits are ``os._exit``: an orderly one could wait on
    the communicators. Without a group it does nothing."""
    if not dist.is_initialized():
        yield
        return
    store = dist.distributed_c10d._get_default_store()
    stop = threading.Event()

    def watch():
        while not stop.wait(poll_s):
            if store.check([_ABORT_KEY]):
                _end(f"rank {store.get(_ABORT_KEY).decode()} failed")
    watcher = threading.Thread(target=watch, daemon=True,
                               name="end_group_on_failure")
    watcher.start()
    try:
        yield
    except Exception:
        traceback.print_exc()
        store.set(_ABORT_KEY, str(process_index()))
        _end("failed")
    finally:
        stop.set()
        watcher.join()


def release_programs() -> None:
    """Free what only reference cycles still hold (an entry point's
    compiled programs, once it has returned) and wait for this rank's card:
    after it, no graph of a returned entry point holds a communicator."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def releases_programs(main):
    """``main`` (an entry point) followed, in a process group, by
    ``release_programs`` once its frame, and every name of it, is gone."""
    @functools.wraps(main)
    def run(*args, **kwargs):
        out = main(*args, **kwargs)
        if dist.is_initialized():
            release_programs()
        return out
    return run
