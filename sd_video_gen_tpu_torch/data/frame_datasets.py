"""Frame-tree datasets: clip indexing over PNG directory trees + MovingMNIST
(``sd_video_gen_tpu/data/frame_datasets.py``; the port keeps its own copy,
and the same tree, seed and arguments give the same clips byte for byte).

Semantics mirror the reference loaders so identical directory layouts yield
identical clip sets:
  - BouncingBall (loaders/bouncing_ball_loader.py:14-91): crawl
    ``dir/{train,test}``; filenames end in a 3-digit frame id under a 4-digit
    parent folder; clips of ``num_frames`` at ``stride`` spacing, rejected on
    parent-folder mismatch.
  - Kitti (loaders/kitti_loader.py:15-100): same crawl + per-frame center
    square crop and resize to ``frame_size``; clips must reach full length.
  - MovingMNIST (loaders/moving_mnist_loader.py:14-38): ``mnist_test_seq.npy``
    (T, N, H, W) -> (N, T, H, W), 80/20 train/test split, stride slicing,
    grayscale stacked to 3 channels.

Frames come back as uint8 BGR (cv2 convention, like the reference), shape
(T, H, W, 3). These are *index* datasets — pixel decode happens in
``__getitem__`` on the host; device-side preprocessing (normalize, resize,
latent-encode) runs in the codec. ``cv2`` is imported inside the functions
that read or resize images.
"""

from __future__ import annotations

import os
import re

import numpy as np


def _crawl_frame_tree(root: str):
    """Collect (sort_key, parent, path) for every PNG; key = int(parent4+frame3)."""
    entries = []
    for dirpath, _, files in os.walk(root):
        parent = os.path.basename(dirpath)
        for f in files:
            if f.endswith(".png"):
                stem = f[:-4]
                frame_digits = stem[-3:]
                if not (frame_digits.isdigit() and parent.isdigit()):
                    continue
                key = int(parent + frame_digits)
                entries.append((key, parent, os.path.join(dirpath, f)))
    entries.sort(key=lambda e: e[0])
    return entries


def _build_clips(entries, num_frames: int, stride: int,
                 require_full: bool) -> tuple[list, list]:
    """Non-overlapping clips of num_frames at `stride` spacing, same parent."""
    indices, clips = [], []
    span = num_frames * stride
    # the LAST clip only needs (num_frames-1)*stride + 1 entries — bounding
    # by the full span dropped valid trailing clips for stride > 1 (in the
    # extreme, a dataset with exactly one strided clip came out empty)
    need = (num_frames - 1) * stride + 1
    for i in range(0, len(entries) - need + 1, span):
        idx_list, names = [], []
        anchor_parent = entries[i][1]
        for k in range(num_frames):
            j = i + k * stride
            if entries[j][1] != anchor_parent:
                break
            idx_list.append(entries[j][0])
            names.append(entries[j][2])
        if require_full and len(names) != num_frames:
            continue
        if names:
            indices.append(idx_list)
            clips.append(names)
    return indices, clips


class _FrameTreeDataset:
    """Base: len/getitem over clip lists; subclass sets per-frame transform."""

    def __init__(self, num_frames: int, stride: int, dir: str, stage: str,
                 shuffle: bool = True, require_full: bool = False,
                 seed: int | None = None):
        self.stage = stage
        self.dir = os.path.join(dir, stage)
        self.num_frames = num_frames
        self.stride = stride
        entries = _crawl_frame_tree(self.dir)
        self.indices, self.clips = _build_clips(entries, num_frames, stride,
                                                require_full)
        if shuffle:
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(self.clips))
            self.clips = [self.clips[i] for i in order]
            self.indices = [self.indices[i] for i in order]

    def __len__(self):
        return len(self.clips)

    def _transform(self, frame: np.ndarray) -> np.ndarray:
        return frame

    def __getitem__(self, index: int):
        import cv2
        frames = [self._transform(cv2.imread(p)) for p in self.clips[index]]
        return self.indices[index], np.stack(frames, axis=0)


class BouncingBallDataset(_FrameTreeDataset):
    # Deviation from loaders/bouncing_ball_loader.py:60-78: partial clips at
    # parent-folder boundaries are dropped (require_full) — the reference kept
    # them, which produces ragged batches that crash any collate; its datasets
    # simply never hit the case.
    def __init__(self, num_frames=5, stride=1, dir="data/bouncing_ball",
                 stage="train", shuffle=True, seed=None):
        super().__init__(num_frames, stride, dir, stage, shuffle,
                         require_full=True, seed=seed)


class KittiDataset(_FrameTreeDataset):
    def __init__(self, num_frames=10, stride=1, dir="data/kitti",
                 stage="train", shuffle=True, frame_size=128, seed=None):
        self.frame_size = frame_size
        super().__init__(num_frames, stride, dir, stage, shuffle,
                         require_full=True, seed=seed)

    def _transform(self, frame: np.ndarray) -> np.ndarray:
        import cv2
        h, w, _ = frame.shape
        if h < w:
            frame = frame[:, (w - h) // 2:(w - h) // 2 + h]
        else:
            frame = frame[(h - w) // 2:(h - w) // 2 + w, :]
        return cv2.resize(frame, (self.frame_size, self.frame_size))


class MovingMNISTDataset:
    def __init__(self, num_frames=20, stride=1, path="mnist_test_seq.npy",
                 stage="train", shuffle=True, seed=None):
        self.num_frames = num_frames
        self.stride = stride
        raw = np.load(path)                      # (T, N, H, W)
        raw = np.transpose(raw, (1, 0, 2, 3))    # (N, T, H, W)
        split = int(len(raw) * 0.8)
        active = raw[:split] if stage == "train" else raw[split:]
        if shuffle:
            rng = np.random.default_rng(seed)
            active = active[rng.permutation(len(active))]
        need = (num_frames - 1) * stride + 1
        if active.shape[1] < need:
            raise ValueError(
                f"MovingMNIST clips have {active.shape[1]} frames; "
                f"num_frames={num_frames} at stride={stride} needs {need} "
                "— silently truncating would train on wrong horizons")
        active = active[:, : num_frames * stride : stride]
        self.data = np.repeat(active[..., None], 3, axis=-1)  # grayscale -> 3ch

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int):
        ids = [f"{index:04d}{j:03d}"
               for j in range(0, self.num_frames * self.stride, self.stride)]
        return ids, self.data[index]
