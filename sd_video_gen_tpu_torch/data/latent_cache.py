"""Pre-encoded latent-clip dataset: train straight from mmap'd latents
(``sd_video_gen_tpu/data/latent_cache.py``; the port keeps its own copy).

Pairs with utils/preprocess.py (the reference's never-wired cache tool,
utils/preprocess.py:15-52, completed here): epochs read (T, latent_dim) f32
clips via numpy memory-mapping — no PNG decode, no VAE encode in the loop.
The trainer detects latent batches by dtype/rank and skips codec.encode.
"""

from __future__ import annotations

import json
import os

import numpy as np


class LatentCacheDataset:
    def __init__(self, cache_dir: str, stage: str = "train"):
        self.latents = np.load(os.path.join(cache_dir, f"{stage}_latents.npy"),
                               mmap_mode="r")
        idx_path = os.path.join(cache_dir, f"{stage}_index.json")
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                self.indices = json.load(f)
        else:
            self.indices = [[i] for i in range(len(self.latents))]

    def __len__(self):
        return len(self.latents)

    def __getitem__(self, i: int):
        return self.indices[i], np.asarray(self.latents[i])
