"""Serving demo: many concurrent video-prediction streams on one card
(``examples/serving_demo.py`` beside the JAX package, on the port).

The inference path end to end without external data or weights (a seeded
model; serve a trained one with ``--checkpoint`` or a reference ``.pt``
with ``--torch_checkpoint``):

  uint8 frames -> PixelCodec encode -> KV-cached incremental AR rollout
  (``ops/cached_rollout``; int8 weights with ``--int8``) -> pixel decode,

repeated over batches of independent streams, in bf16. The rate printed is
generated frames over the wall of a round that ends in a device
synchronise. No rate is quoted here: ``chip_smoke.py`` measures the same
rollout (``pixel_ar16_kvcache``, 256 clips) on the card, and PERF.md keeps
its readings beside the card's name and power limit.

    python -m sd_video_gen_tpu_torch.examples.serving_demo   # tiny model
    ... --flagship                       # dim 2048, 4 enc + 8 dec
    ... --int8                           # int8 weights
    ... --checkpoint checkpoints/<cfg>_<i>_test --config <cfg> [--config_dir]
    ... --torch_checkpoint ref.pt --config <cfg>
    ... --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import time
import types

import numpy as np
import torch

from sd_video_gen_tpu_torch.config import strict_f32


def load_trained(cfg, args, model):
    """Fill ``model`` from ``--torch_checkpoint`` or the port's checkpoint
    directory ``--checkpoint`` (``<config>_<index>_<mode>``: the index and
    mode come from its name, not a guess)."""
    from sd_video_gen_tpu_torch.predict.predict import load_model_params
    if args.torch_checkpoint:
        ns = types.SimpleNamespace(checkpoint_dir=".", config=args.config,
                                   index=0, mode="test",
                                   torch_checkpoint=args.torch_checkpoint)
        return load_model_params(cfg, ns, model, "test")
    base = os.path.basename(args.checkpoint.rstrip("/"))
    m = re.search(r"_(\d+)_(\w+)$", base)
    idx, mode = (int(m.group(1)), m.group(2)) if m else (0, "test")
    ns = types.SimpleNamespace(
        checkpoint_dir=os.path.dirname(args.checkpoint.rstrip("/")) or ".",
        config=args.config, index=idx, mode=mode, torch_checkpoint=None)
    return load_model_params(cfg, ns, model, mode)


def main(argv=None):
    strict_f32()
    from sd_video_gen_tpu_torch.codecs import PixelCodec
    from sd_video_gen_tpu_torch.config import load_config
    from sd_video_gen_tpu_torch.models import build, default_device
    from sd_video_gen_tpu_torch.models.transformer import (
        FrameTransformer, FrameTransformerConfig)
    from sd_video_gen_tpu_torch.ops.cached_rollout import (
        cached_rollout, quantize_rollout_params)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flagship", action="store_true",
                    help="dim 2048, 4 enc + 8 dec (else a tiny model)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="concurrent streams (default: 256 flagship / 8 tiny)")
    ap.add_argument("--frames", type=int, default=16, help="frames per stream")
    ap.add_argument("--frame_size", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="the port's checkpoint directory from the trainer")
    ap.add_argument("--torch_checkpoint", type=str, default=None,
                    help="a reference-trained .pt state_dict")
    ap.add_argument("--config", type=str, default=None,
                    help="config name (required with --checkpoint)")
    ap.add_argument("--config_dir", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    trained = args.checkpoint or args.torch_checkpoint
    if trained and not args.config:
        ap.error("--config is required with --checkpoint / "
                 "--torch_checkpoint (the model dims and frame size come "
                 "from it)")
    device = default_device(args.device)

    if trained:
        # a trained checkpoint's dims and frame size come from ITS config
        cfg = load_config(args.config, args.config_dir)
        codec = PixelCodec(cfg.frame_size, device)
        mc = FrameTransformerConfig.from_config(cfg)
        batch = args.batch or 8
    else:
        codec = PixelCodec(args.frame_size, device)
        if args.flagship:
            dims = dict(dim_model=2048, num_heads=8, num_encoder_layers=4,
                        num_decoder_layers=8)
            batch = args.batch or 256
        else:
            dims = dict(dim_model=128, num_heads=4, num_encoder_layers=2,
                        num_decoder_layers=2)
            batch = args.batch or 8
        mc = FrameTransformerConfig(latent_dim=codec.latent_dim,
                                    dropout_p=0.0, **dims)
    mc = dataclasses.replace(mc, dropout_p=0.0)
    model = build(FrameTransformer, mc, device)
    if trained:
        model = load_trained(cfg, args, model)
    else:
        print("no checkpoint given: serving a seeded model (throughput demo "
              "only)")
    model = model.to(torch.bfloat16)
    params = quantize_rollout_params(model) if args.int8 else model

    context = 5
    fsize = codec.frame_size
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, context, fsize, fsize, 3), dtype=np.uint8)).to(device)

    @torch.inference_mode()
    def serve(frames_u8):
        lat = codec.encode_batch(frames_u8, use_sos=True)
        preds = cached_rollout(mc, params, lat, args.frames)
        return codec.decode_latents(preds.reshape(-1, codec.latent_dim))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    serve(frames)                                    # warm-up
    sync()
    total, best = 0.0, float("inf")
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        out = serve(frames)
        sync()
        dt = time.perf_counter() - t0
        total += dt
        best = min(best, dt)
    n = batch * args.frames
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device={name} streams={batch} frames/stream={args.frames} "
          f"int8={args.int8}")
    print(f"generated {n} frames/round: best {n / best:,.0f} frames/sec "
          f"(mean {n * args.rounds / total:,.0f})")
    print(f"output: {tuple(out.shape)} {out.dtype}")
    return out


if __name__ == "__main__":
    main()
