"""UCF-101 loader throughput: video-grouped epoch order against a clip
shuffle, and the native frame cache (``tools/bench_ucf_loader.py`` beside
the JAX package, on the port's ``data/ucf101.py`` and
``data/native_loader.py``).

Writes a small UCF tree (8 MJPG videos of 120 frames at 64px, so each holds
many clips), then measures clips/s of:
  grouped  - ``UCF101Dataset.epoch_order`` (videos shuffled, clips in order):
             one decode per video per epoch, the trainer's default;
  shuffled - a clip-level shuffle (the reference's RandomSampler): the
             decode cache (2 videos) misses on almost every fetch;
  native   - ``build_frame_cache`` once, then ``NativeBatchLoader`` (batch
             32, 2 threads) serving shuffled batches from the mmap'd cache.

A host tool: the numbers are the host CPU's. It needs ``cv2`` to write and
decode the ``.avi`` files and raises without it.

    python -m sd_video_gen_tpu_torch.tools.bench_ucf_loader

Prints one JSON line with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from sd_video_gen_tpu_torch.config import strict_f32

N_VIDEOS = 8
FRAMES = 120
SIZE = 64


def build_tree(root: str, n_videos: int = N_VIDEOS, frames: int = FRAMES,
               size: int = SIZE) -> tuple[str, str]:
    """The JAX tool's tree: one class, ``n_videos`` MJPG videos of seeded
    noise frames, all in the train list; the first in the test list."""
    import cv2
    data = os.path.join(root, "UCF-101")
    cls = "ApplyLipstick"
    os.makedirs(os.path.join(data, cls))
    names = []
    for vi in range(n_videos):
        name = f"v_{cls}_g{vi:02d}_c01.avi"
        vw = cv2.VideoWriter(os.path.join(data, cls, name),
                             cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                             (size, size))
        rng = np.random.default_rng(vi)
        for _ in range(frames):
            vw.write(rng.integers(0, 255, (size, size, 3), np.uint8))
        vw.release()
        names.append(f"{cls}/{name}")
    splits = os.path.join(root, "splits")
    os.makedirs(splits)
    with open(os.path.join(splits, "trainlist01.txt"), "w") as f:
        for n in names:
            f.write(f"{n} 1\n")
    with open(os.path.join(splits, "testlist01.txt"), "w") as f:
        f.write(names[0] + "\n")
    return data, splits


def measure(ds, order) -> float:
    t0 = time.perf_counter()
    for idx in order:
        _ = ds[int(idx)]
    return len(order) / (time.perf_counter() - t0)


def run(root: str, n_videos: int = N_VIDEOS, frames: int = FRAMES,
        size: int = SIZE) -> dict:
    """The three measurements on a tree written under ``root``."""
    from sd_video_gen_tpu_torch.data.native_loader import (NativeBatchLoader,
                                                           build_frame_cache)
    from sd_video_gen_tpu_torch.data.ucf101 import UCF101Dataset
    data, splits = build_tree(root, n_videos, frames, size)
    # cache_videos=2 << N_VIDEOS emulates real UCF (13K videos >> any
    # cache): grouped order stays hot, clip-shuffle thrashes.
    ds = UCF101Dataset(data, splits, frames_per_clip=10, train=True,
                       frame_rate=None, frame_size=size, cache_videos=2)
    n = len(ds)
    rng = np.random.default_rng(0)
    grouped = ds.epoch_order(rng)
    shuffled = rng.permutation(n)
    _ = ds[0]  # warm the codec and the cache machinery
    g = measure(ds, grouped)
    s = measure(ds, shuffled)

    # native path: one cache build, then the C++ loader serves shuffled
    # batches from the mmap: decode paid once ever, not once per epoch
    cache_dir = os.path.join(root, "cache")
    t0 = time.perf_counter()
    build_frame_cache(ds, cache_dir, "train")
    t_build = time.perf_counter() - t0
    loader = NativeBatchLoader(cache_dir, "train", batch_size=32,
                               n_threads=2, seed=0)
    try:
        for _ in loader:  # warm epoch (page cache)
            pass
        t0 = time.perf_counter()
        served = 0
        for _, batch in loader:
            served += len(batch)
        nat = served / (time.perf_counter() - t0)
    finally:
        loader.close()
    return {"clips": n, "grouped_clips_per_sec": round(g, 1),
            "clip_shuffled_clips_per_sec": round(s, 1),
            "speedup": round(g / s, 1),
            "native_clips_per_sec": round(nat, 1),
            "native_cache_build_sec": round(t_build, 2),
            "native_vs_grouped": round(nat / g, 1)}


def main(argv=None) -> int:
    strict_f32()
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    with tempfile.TemporaryDirectory() as root:
        print(json.dumps(run(root)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
