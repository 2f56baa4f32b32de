"""Offline latent-cache tool: encode frame trees to .npy once, up front
(``sd_video_gen_tpu/utils/preprocess.py``).

Writes ONE contiguous (N, T, latent_dim) f32 array + clip index per stage,
which ``data/latent_cache.LatentCacheDataset`` memory-maps for epochs with no
image decode and no codec in the loop (``train.trainer --latent_cache``).

The encode is one compiled program per batch shape (``utils/jit.py``: a
CUDA graph on the card; the ragged last batch is a second), the JAX tool's
jitted ``encode``; each batch is copied to the codec's device first.

Usage:
  python -m sd_video_gen_tpu_torch.utils.preprocess --dataset ball \
      --folder <dir> --config <cfg> [--codec vae --vae_weights vae.pt] \
      --out cache/ [--device cpu]
"""

from __future__ import annotations

import functools
import json
import os
import warnings

import numpy as np
import torch

from sd_video_gen_tpu_torch.codecs import make_codec
from sd_video_gen_tpu_torch.config import (add_device_flag, build_arg_parser,
                                           load_config, strict_f32)
from sd_video_gen_tpu_torch.utils.jit import jit


@functools.lru_cache(maxsize=1)
def jitted_encode(codec):
    """``codec.encode_frames`` as one compiled program of this codec (one
    codec's at a time: its graphs hold their memory pool)."""
    return jit(codec.encode_frames, name="encode")


@torch.no_grad()
def build_latent_cache(dataset, codec, out_dir: str, stage: str,
                       batch: int = 16) -> str:
    os.makedirs(out_dir, exist_ok=True)
    lats, indices = [], []
    for start in range(0, len(dataset), batch):
        frames = []
        for i in range(start, min(start + batch, len(dataset))):
            idx, fr = dataset[i]
            indices.append(list(map(int, idx)) if hasattr(idx, "__len__")
                           else [int(idx)])
            frames.append(fr)
        x = torch.from_numpy(np.stack(frames)).to(codec.device)
        lats.append(jitted_encode(codec)(x).float().cpu().numpy())
    arr = np.concatenate(lats, axis=0).astype(np.float32)
    path = os.path.join(out_dir, f"{stage}_latents.npy")
    np.save(path, arr)
    with open(os.path.join(out_dir, f"{stage}_index.json"), "w") as f:
        json.dump(indices, f)
    return path


def main(argv=None):
    strict_f32()
    p = build_arg_parser()
    p.add_argument("--codec", type=str, default="pixel",
                   choices=["pixel", "vae"])
    p.add_argument("--out", type=str, default="latent_cache")
    args = add_device_flag(p).parse_args(argv)
    cfg = load_config(args.config, args.config_dir)

    vae = None
    if args.codec == "vae" and args.vae_weights:
        from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
        from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
        vae = build_from_file(AutoencoderKL, VAEConfig(), "vae",
                              args.vae_weights, args.device)
    elif args.codec == "vae":
        # a latent cache is a PERSISTENT artifact; encoding it with a
        # random-init VAE writes garbage to disk that silently poisons
        # every later training run
        warnings.warn(
            "--codec vae without --vae_weights: building the latent cache "
            "with a RANDOM-INIT VAE — the cached latents are meaningless "
            "for real training", stacklevel=1)
    codec = make_codec(cfg, args.codec, vae=vae, device=args.device)

    from sd_video_gen_tpu_torch.train.trainer import build_dataset
    for stage in ("train", "test"):
        ds = build_dataset(cfg, args, stage)
        path = build_latent_cache(ds, codec, args.out, stage)
        print(f"{stage}: {len(ds)} clips -> {path}")


if __name__ == "__main__":
    main()
