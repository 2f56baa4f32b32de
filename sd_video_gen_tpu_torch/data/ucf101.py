"""UCF-101 dataset: .avi clips via OpenCV, official split lists
(``sd_video_gen_tpu/data/ucf101.py``; the port keeps its own copy, and the
same tree, split lists, seed and arguments give the same clips byte for
byte).

Replaces torchvision.datasets.UCF101 + the reference's lambda-transform
pipeline (trainers/trainer.py:389-421) with the SAME clip enumeration
semantics and a decode strategy that can keep a device fed:

Clip enumeration (torchvision VideoClips parity):
  - per video, the frame timeline is resampled from its native fps to
    ``frame_rate`` with torchvision's formula: n_rs = floor(T * new/orig);
    integer step -> arange(0, T, step), fractional -> floor(arange(n_rs) *
    orig/new).
  - ALL sliding windows of ``frames_per_clip`` resampled frames with
    ``step_between_clips`` (reference default 1) become clips.
    ``clips_per_video`` optionally caps the count (None = torchvision).

Decode strategy:
  - an LRU cache holds whole decoded+resampled videos; a video is decoded
    ONCE and all its clips are slices.
  - ``epoch_order`` offers video-grouped sampling (videos shuffled, clips
    within a video sequential) which BatchLoader uses so the cache stays hot;
    ``sampling='clip'`` gives the reference's clip-level RandomSampler
    statistics (pre-decode through data/native_loader.py for speed).

Pixel path parity: decode at a target frame rate, resize to ``frame_size``
(nearest: the reference used F.interpolate's default), optional horizontal
flip; cv2 decodes BGR, which is what the reference's final channel swap
produced. Returns ``(labels, frames)`` with frames uint8 (T, H, W, 3) BGR.
``cv2`` is imported inside the functions that read video.
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict

import numpy as np


def find_classes(root: str) -> list[str]:
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def _read_split_videos(label_dir: str, train: bool, fold: int = 1) -> set[str]:
    """Parse ucfTrainTestlist files -> set of 'Class/video.avi' names."""
    tag = "train" if train else "test"
    path = os.path.join(label_dir, f"{tag}list{fold:02d}.txt")
    names = set()
    with open(path) as f:
        for line in f:
            part = line.strip().split()
            if part:
                names.add(part[0])
    return names


def resample_indices(total_frames: int, original_fps: float,
                     new_fps: float | None) -> np.ndarray:
    """torchvision VideoClips._resample_video_idx, exactly.

    Integer step: every step-th frame of the whole video (slice semantics,
    ceil(T/step) frames). Fractional: floor(arange(floor(T*new/orig)) *
    orig/new), the arange in float32 as torchvision computes it."""
    if new_fps is None or original_fps <= 0:
        return np.arange(total_frames, dtype=np.int64)
    step = float(original_fps) / float(new_fps)
    if step.is_integer():
        return np.arange(0, total_frames, int(step), dtype=np.int64)
    n_rs = int(np.floor(total_frames * float(new_fps) / float(original_fps)))
    idxs = np.floor(np.arange(n_rs, dtype=np.float32) * step)
    return idxs.astype(np.int64)


def clip_starts(n_resampled: int, frames_per_clip: int,
                step_between_clips: int = 1) -> np.ndarray:
    """Sliding-window starts, torchvision unfold semantics:
    max(0, (n - size)//step + 1) windows."""
    if n_resampled < frames_per_clip:
        return np.empty(0, dtype=np.int64)
    n = (n_resampled - frames_per_clip) // step_between_clips + 1
    return np.arange(n, dtype=np.int64) * step_between_clips


def _video_metadata(path: str) -> tuple[int, float]:
    import cv2
    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    fps = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
    cap.release()
    return total, fps


def _decode_resampled(path: str, idxs: np.ndarray,
                      frame_size: int) -> np.ndarray:
    """Decode one video, keep the resampled frames, resize. (n, H, W, 3) u8."""
    import cv2
    want = set(int(i) for i in idxs)
    last = max(want) if want else -1
    by_src: dict[int, np.ndarray] = {}
    cap = cv2.VideoCapture(path)
    i = 0
    while i <= last:
        ok, frame = cap.read()
        if not ok:
            break
        if i in want:
            # INTER_NEAREST: the reference resized UCF frames with torch
            # F.interpolate's default 'nearest' (trainers/trainer.py:397)
            by_src[i] = cv2.resize(frame, (frame_size, frame_size),
                                   interpolation=cv2.INTER_NEAREST)
        i += 1
    cap.release()
    out = []
    prev = np.zeros((frame_size, frame_size, 3), np.uint8)
    for j in idxs:
        # metadata frame counts can exceed decodable frames; repeat the last
        prev = by_src.get(int(j), prev)
        out.append(prev)
    return (np.stack(out, 0) if out
            else np.zeros((0, frame_size, frame_size, 3), np.uint8))


class UCF101Dataset:
    """Sliding-window clip index over the UCF .avi tree; LRU decode cache."""

    def __init__(self, data_dir: str, label_dir: str, frames_per_clip: int = 5,
                 train: bool = True, frame_rate: float | None = 3,
                 frame_size: int = 128, flip: bool = False,
                 clips_per_video: int | None = None, seed: int = 0,
                 step_between_clips: int = 1, cache_videos: int = 32,
                 sampling: str = "grouped"):
        if sampling not in ("grouped", "clip"):
            raise ValueError("sampling must be 'grouped' or 'clip'")
        self.sampling = sampling
        self.frames_per_clip = frames_per_clip
        self.frame_rate = frame_rate
        self.frame_size = frame_size
        self.flip = flip
        self.step_between_clips = step_between_clips
        self.cache_videos = max(1, cache_videos)
        self._rng = np.random.default_rng(seed)

        self.classes = find_classes(data_dir)
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        split = _read_split_videos(label_dir, train)

        self.videos = []       # (path, label, resample idxs)
        self.items = []        # (video_idx, resampled start)
        self._video_item_ranges = []  # contiguous [lo, hi) into items
        for c in self.classes:
            for p in sorted(glob.glob(os.path.join(data_dir, c, "*.avi"))):
                if f"{c}/{os.path.basename(p)}" not in split:
                    continue
                total, fps = _video_metadata(p)
                idxs = resample_indices(total, fps, frame_rate)
                starts = clip_starts(len(idxs), frames_per_clip,
                                     step_between_clips)
                if clips_per_video is not None:
                    starts = starts[:clips_per_video]
                if len(starts) == 0:
                    continue
                v = len(self.videos)
                self.videos.append((p, self.class_to_idx[c], idxs))
                lo = len(self.items)
                self.items.extend((v, int(s)) for s in starts)
                self._video_item_ranges.append((lo, len(self.items)))
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()

    def __len__(self):
        return len(self.items)

    def epoch_order(self, rng: np.random.Generator) -> np.ndarray:
        """Epoch sampling order consumed by BatchLoader.

        ``sampling='grouped'`` (default): videos shuffled, clips within a
        video sequential (keeps the decode cache hot). ``sampling='clip'``:
        a uniform clip-level permutation, the reference's RandomSampler
        statistics."""
        if self.sampling == "clip":
            return rng.permutation(len(self))
        order = rng.permutation(len(self.videos))
        return np.concatenate([
            np.arange(*self._video_item_ranges[v]) for v in order]) \
            if len(self.videos) else np.empty(0, np.int64)

    def _frames_for_video(self, v: int) -> np.ndarray:
        if v in self._cache:
            self._cache.move_to_end(v)
            return self._cache[v]
        path, _, idxs = self.videos[v]
        frames = _decode_resampled(path, idxs, self.frame_size)
        self._cache[v] = frames
        while len(self._cache) > self.cache_videos:
            self._cache.popitem(last=False)
        return frames

    def __getitem__(self, index: int):
        v, start = self.items[index]
        label = self.videos[v][1]
        video = self._frames_for_video(v)
        frames = video[start:start + self.frames_per_clip]
        if len(frames) < self.frames_per_clip:  # decode came up short
            pad = np.repeat(frames[-1:] if len(frames) else
                            np.zeros((1, self.frame_size, self.frame_size, 3),
                                     np.uint8),
                            self.frames_per_clip - len(frames), axis=0)
            frames = np.concatenate([frames, pad], 0)
        if self.flip and self._rng.random() > 0.5:
            frames = frames[:, :, ::-1]
        return [label] * self.frames_per_clip, np.ascontiguousarray(frames)

    @classmethod
    def from_args(cls, cfg, args, stage: str,
                  exact_frames: int | None = None) -> "UCF101Dataset":
        # directory dispatch mirroring trainers/trainer.py:372-387
        if args.folder is not None:
            data_dir = args.folder
        else:
            suffix = {"ucf_wallpushups": "UCF-101-wallpushups",
                      "ucf_workout": "UCF-101-workout",
                      "ucf_instruments": "UCF-101-instruments",
                      "ucf": "UCF-101"}.get(args.dataset)
            if suffix is None:
                raise ValueError(f"Invalid dataset name {args.dataset}")
            data_dir = os.path.join("data/UCF-101", suffix)
        label_dir = getattr(
            args, "ucf_labels",
            "data/UCF101TrainTestSplits-RecognitionTask/ucfTrainTestlist")
        n = exact_frames
        if n is None:
            n = cfg.frames_per_clip
            # learned_tgt trains on the same future split (src drops the last
            # k frames), so it needs the extended clips too: without them src
            # would be empty and the model would train with no context
            if getattr(args, "train_mode", "ar") in ("future", "learned_tgt"):
                n += cfg.frames_to_predict
        # augmentation is a TRAIN-stage concern: flipping val/test clips
        # would randomize validation losses and FVD ground-truth statistics
        return cls(data_dir, label_dir, frames_per_clip=n,
                   train=stage == "train", frame_rate=cfg.fps,
                   frame_size=cfg.frame_size,
                   flip=bool(getattr(args, "flip", False)) and stage == "train",
                   seed=args.seed)
