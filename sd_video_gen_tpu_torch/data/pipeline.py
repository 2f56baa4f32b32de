"""Host input pipeline: sampling, batching, background prefetch
(``sd_video_gen_tpu/data/pipeline.py``; the port keeps its own copy, and the
same dataset, seed and arguments give the same epoch order and batches).

Replaces the reference's torch DataLoader(num_workers=12, RandomSampler with
num_samples=len*EPOCH_RATIO — trainers/trainer.py:412-421) with a
thread-prefetched iterator that overlaps PNG/video decode with device compute.
The device side (normalize/resize/VAE-encode) is NOT done here: it runs
inside the train/predict step, on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


class BatchLoader:
    """Iterate (indices_list, frames uint8 (B,T,H,W,3)) batches.

    - ``epoch_ratio`` subsamples each epoch without replacement (reference
      RandomSampler semantics).
    - ``drop_last`` keeps batch shapes static (the reference padded nothing
      and simply got a ragged last batch).
    - ``prefetch`` decodes ahead on a background thread.
    """

    def __init__(self, dataset, batch_size: int, epoch_ratio: float = 1.0,
                 shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 2, seed: int = 0,
                 process_shard: tuple[int, int] | None = None,
                 shard_multiple: int | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.epoch_ratio = epoch_ratio
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        # multi-host: (process_index, process_count). Every process derives
        # the IDENTICAL global epoch order from the shared seed, then reads
        # and decodes ONLY its contiguous slice of each global batch, so
        # host IO stays local.
        if process_shard is not None:
            pid, pcount = process_shard
            if batch_size % pcount:
                raise ValueError(
                    f"global batch_size {batch_size} must divide evenly "
                    f"across {pcount} processes")
            if not (0 <= pid < pcount):
                raise ValueError(f"process_shard index {pid} out of range")
        self.process_shard = process_shard
        # ragged (short) batches are trimmed to a multiple of this so the
        # global batch stays shardable over the whole device mesh (the
        # trainer passes the mesh's data-axis requirement) — on SINGLE
        # host too: an untrimmed short batch does not split evenly over a
        # data axis. Full batches are never trimmed; the check below
        # refuses batch sizes that cannot shard evenly.
        self.shard_multiple = (shard_multiple if shard_multiple is not None
                               else (process_shard[1] if process_shard
                                     else None))
        self._mult = max(self.shard_multiple or 1,
                         process_shard[1] if process_shard else 1)
        if self._mult > 1 and batch_size % self._mult:
            # refuse loudly: trimming every FULL batch to a multiple of
            # the mesh requirement would silently drop clips (or yield
            # empty epochs when batch_size < mult)
            raise ValueError(
                f"global batch_size {batch_size} must be a multiple of "
                f"shard_multiple {self._mult} (the mesh batch-axis "
                "requirement) — every batch must shard evenly")
        if process_shard is not None and self._mult % process_shard[1]:
            # a ragged tail trims to a multiple of _mult, then splits into
            # per-process slices of _mult // pcount — a non-divisible pair
            # would yield a trimmed GLOBAL tail that no longer shards over
            # the mesh (the trainer always passes lcm(data_axis, pcount))
            raise ValueError(
                f"shard_multiple {self._mult} must be a multiple of the "
                f"process count {process_shard[1]} — pass "
                "lcm(mesh data axis, process count)")

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        take = max(1, int(n * self.epoch_ratio))
        if self.shuffle and hasattr(self.dataset, "epoch_order"):
            # dataset-directed sampling (UCF: videos shuffled, clips within a
            # video sequential so its decode cache stays hot)
            order = np.asarray(self.dataset.epoch_order(self._rng))
        elif self.shuffle:
            order = self._rng.permutation(n)
        else:
            order = np.arange(n)
        return order[:take]

    def __len__(self) -> int:
        take = max(1, int(len(self.dataset) * self.epoch_ratio))
        mult = self._mult
        nfull, rem = divmod(take, self.batch_size)
        if nfull and self.drop_last:
            return nfull
        # ragged batches survive sharding only if they trim to a non-zero
        # mesh-shardable size (__iter__ applies the same rule)
        ragged = rem if nfull else take
        return nfull + (1 if (ragged // mult) * mult else 0)

    def _assemble(self, idxs: Sequence[int]):
        items = [self.dataset[int(i)] for i in idxs]
        indices = [it[0] for it in items]
        frames = np.stack([it[1] for it in items], axis=0)
        return indices, frames

    def __iter__(self) -> Iterator:
        order = self._epoch_order()
        nb = len(self)
        if nb == 0:
            return
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        batches = [b for b in batches if len(b)]
        if self._mult > 1 or self.process_shard is not None:
            # trim ragged short batches to the largest mesh-shardable size
            # (all processes stay consistent; single-host short batches
            # still split evenly over a data axis), and each process
            # takes its contiguous slice of every global batch.
            pid, pcount = self.process_shard or (0, 1)
            mult = self._mult
            out = []
            for b in batches:
                m = (len(b) // mult) * mult  # mesh-shardable size
                local = m // pcount
                if local:
                    out.append(b[pid * local:(pid + 1) * local])
            batches = out

        if self.prefetch <= 0:
            for b in batches:
                yield self._assemble(b)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer is gone —
            # an abandoned iterator (break / next(iter(...))) must not
            # leave the worker blocked forever holding decoded batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in batches:
                    if stop.is_set() or not _put(self._assemble(b)):
                        return
                _put(SENTINEL)
            except BaseException as e:  # propagate decode errors to consumer
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
