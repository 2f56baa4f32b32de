"""Synthetic bouncing-ball renderer: hermetic data for tests, benches, demos
(``sd_video_gen_tpu/data/synthetic.py``; the port keeps its own copy, and
the same seed and arguments give the same tree byte for byte).

The reference depends on pre-rendered PNG trees on disk; this generator
produces the same directory layout (``dir/{train,test}/<NNNN>/<NNNN><FFF>.png``)
so loaders and CLIs run without external datasets. ``cv2`` is imported inside
the functions that draw and write.
"""

from __future__ import annotations

import os

import numpy as np


def _render_sequence(n_frames: int, size: int, rng: np.random.Generator,
                     radius: int | None = None) -> np.ndarray:
    import cv2
    radius = radius or max(3, size // 8)
    pos = rng.uniform(radius, size - radius, 2)
    vel = rng.uniform(-size / 8, size / 8, 2)
    while np.allclose(vel, 0):
        vel = rng.uniform(-size / 8, size / 8, 2)
    color = tuple(int(c) for c in rng.integers(100, 256, 3))
    frames = np.zeros((n_frames, size, size, 3), np.uint8)
    for t in range(n_frames):
        for ax in range(2):
            if pos[ax] - radius < 0 or pos[ax] + radius > size:
                vel[ax] = -vel[ax]
                pos[ax] = np.clip(pos[ax], radius, size - radius)
        cv2.circle(frames[t], (int(pos[0]), int(pos[1])), radius, color, -1)
        pos += vel
    return frames


def generate_bouncing_ball_tree(root: str, n_train_seqs: int = 4,
                                n_test_seqs: int = 2, frames_per_seq: int = 10,
                                size: int = 64, seed: int = 0) -> str:
    """Write a reference-layout PNG tree under ``root``; returns ``root``."""
    import cv2
    if frames_per_seq > 999:
        # the reference frame-id layout is <seq:04d><frame:03d>; a 4-digit
        # frame id silently scrambles the loader's sort order
        raise ValueError("frames_per_seq > 999 breaks the 3-digit frame-id "
                         "naming contract (loader sorts on the last 3 "
                         "digits)")
    rng = np.random.default_rng(seed)
    seq_id = 0
    for stage, n in (("train", n_train_seqs), ("test", n_test_seqs)):
        for _ in range(n):
            seq_id += 1
            d = os.path.join(root, stage, f"{seq_id:04d}")
            os.makedirs(d, exist_ok=True)
            frames = _render_sequence(frames_per_seq, size, rng)
            for t, fr in enumerate(frames):
                cv2.imwrite(os.path.join(d, f"{seq_id:04d}{t:03d}.png"), fr)
    return root
