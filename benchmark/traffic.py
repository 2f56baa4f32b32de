"""The one generator of every traffic mix: clips of bouncing balls from a
seed, at the sizes a traffic file (``benchmark/traffic/<name>.json``) gives.

A clip is a filled disc of one colour moving at a constant velocity that
reflects off the frame's edges, over a black background, uint8 BGR. Every
request of a run has the same sizes; the seed moves only the balls.
"""

from __future__ import annotations

import numpy as np

from benchmark.weights import mix


def render(rng: np.random.Generator, clips: int, frames: int,
           size: int) -> np.ndarray:
    """(clips, frames, size, size, 3) uint8."""
    radius = max(3, size // 8)
    pos = rng.uniform(radius, size - radius, (clips, 2))
    vel = rng.uniform(-size / 8, size / 8, (clips, 2))
    vel[np.abs(vel).sum(1) < 1e-3] = 1.0
    color = rng.integers(100, 256, (clips, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.zeros((clips, frames, size, size, 3), np.uint8)
    for t in range(frames):
        low, high = pos - radius < 0, pos + radius > size
        vel[low | high] *= -1
        pos = np.clip(pos, radius, size - radius)
        disc = ((xx[None] - pos[:, 0, None, None]) ** 2
                + (yy[None] - pos[:, 1, None, None]) ** 2) <= radius ** 2
        out[:, t][disc] = np.repeat(color, disc.reshape(clips, -1).sum(1), 0)
        pos = pos + vel
    return out


def clips(traffic: dict, seed: int, index: int) -> np.ndarray:
    """Request ``index`` of a run seeded ``seed``: ``clips_per_request``
    clips of ``context_frames`` frames of ``frame_size`` px."""
    rng = np.random.default_rng(mix(seed, "request", index))
    return render(rng, traffic["clips_per_request"],
                  traffic["context_frames"], traffic["frame_size"])


def train_batches(traffic: dict, seed: int) -> list:
    """The run's ``pool`` batches of ``clips_per_step`` clips of
    ``clip_frames`` frames, all different; a run's steps cycle through
    them as a loader cycles through a dataset held in memory."""
    return [render(np.random.default_rng(mix(seed, "batch", i)),
                   traffic["clips_per_step"], traffic["clip_frames"],
                   traffic["frame_size"]) for i in range(traffic["pool"])]
