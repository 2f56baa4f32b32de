"""Offline FVD between two directories of frame images
(``sd_video_gen_tpu/evaluation/compute_fvd_from_files.py``).

  python -m sd_video_gen_tpu_torch.evaluation.compute_fvd_from_files \
      --real_dir <dir> --fake_dir <dir> [--seq_len 15] [--size 128] \
      [--i3d_weights i3d.pt] [--device cpu]

Each directory's ``.png`` / ``.jpg`` files are found recursively, grouped by
the directory that holds them (a sequence never spans two videos), ordered
numerically within it (``10.png`` after ``9.png``) and cut into sequences of
``--seq_len`` frames, resized to ``--size``; their I3D logits (``--batch``
sequences at a time, ``fvd.get_fvd_logits``: one compiled program per
batch shape on the card, the JAX tool's jitted ``features``) give the
batch-lineage Fréchet distance. ``cv2`` is imported inside the reader.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from sd_video_gen_tpu_torch.config import add_device_flag, strict_f32
from sd_video_gen_tpu_torch.evaluation.fvd import (frechet_distance,
                                                   get_fvd_logits)
from sd_video_gen_tpu_torch.evaluation.predict_fvd import load_i3d


def _frame_key(path: str):
    """Numeric-aware order: '10.png' sorts after '9.png' (plain
    lexicographic order scrambles the unpadded names the predict CLI
    writes, outputs/<n>/<i>.png)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    digits = "".join(c for c in stem if c.isdigit())
    return (int(digits) if digits else 0, stem)


def _sequence_paths(root: str, seq_len: int, max_seqs: int) -> list:
    """The frame paths of each sequence, in order."""
    paths = (glob.glob(os.path.join(root, "**", "*.png"), recursive=True)
             + glob.glob(os.path.join(root, "**", "*.jpg"), recursive=True))
    by_dir: dict = {}
    for pth in paths:
        by_dir.setdefault(os.path.dirname(pth), []).append(pth)
    seqs = []
    for d in sorted(by_dir):
        frames = sorted(by_dir[d], key=_frame_key)
        for i in range(len(frames) // seq_len):
            if len(seqs) >= max_seqs:
                break
            seqs.append(frames[i * seq_len:(i + 1) * seq_len])
    return seqs


def _load_sequences(root: str, seq_len: int, max_seqs: int,
                    size: int) -> np.ndarray:
    """(N, seq_len, size, size, 3) uint8 BGR."""
    import cv2
    seqs = [np.stack([cv2.resize(cv2.imread(p), (size, size)) for p in s])
            for s in _sequence_paths(root, seq_len, max_seqs)]
    if not seqs:
        raise FileNotFoundError(
            f"no complete {seq_len}-frame sequences under {root}")
    return np.stack(seqs)


def main(argv=None):
    strict_f32()
    p = argparse.ArgumentParser()
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--seq_len", type=int, default=15)
    p.add_argument("--max_seqs", type=int, default=128 * 16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--i3d_weights", type=str, default=None)
    args = add_device_flag(p).parse_args(argv)

    i3d = load_i3d(args.i3d_weights, args.device)

    def all_feats(root):
        seqs = _load_sequences(root, args.seq_len, args.max_seqs, args.size)
        with torch.inference_mode():
            return get_fvd_logits(i3d, seqs, args.batch).cpu().numpy()

    fvd = frechet_distance(all_feats(args.real_dir),
                           all_feats(args.fake_dir))
    print(f"FVD: {fvd:.3f}")
    return fvd


if __name__ == "__main__":
    main()
