"""80/20 train/test folder split tool (``sd_video_gen_tpu/utils/format_data.py``;
the port keeps its own copy, and the same tree and seed make the same moves).

Reference: utils/format_data.py:4-23: move sequence subfolders of a dataset
root into train/ and test/ at an 80/20 ratio. Split is by sequence folder
(never splitting frames of one sequence across stages).

Usage: python -m sd_video_gen_tpu_torch.utils.format_data --dir <root>
[--ratio 0.8] [--seed N]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil


def split_dataset(root: str, ratio: float = 0.8,
                  seed: int | None = None) -> tuple[int, int]:
    """Move the sequence folders of ``root`` into ``root/train`` and
    ``root/test``: the first ``int(n * ratio)`` in sorted order (shuffled by
    ``random.Random(seed)`` when a seed is given) to train, the rest to test.
    Returns (moved to train, moved to test)."""
    seqs = sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d))
                  and d not in ("train", "test"))
    if seed is not None:
        random.Random(seed).shuffle(seqs)
    n_train = int(len(seqs) * ratio)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    for i, d in enumerate(seqs):
        dst = "train" if i < n_train else "test"
        shutil.move(os.path.join(root, d), os.path.join(root, dst, d))
    return n_train, len(seqs) - n_train


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    tr, te = split_dataset(args.dir, args.ratio, args.seed)
    print(f"moved {tr} sequences to train/, {te} to test/")


if __name__ == "__main__":
    main()
