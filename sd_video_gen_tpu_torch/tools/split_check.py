"""Does a data-parallel step's gradient differ from one process's by more
than the rounding of a sum's order? ``train_flagship``'s FrameTransformer
and loss in f32 at dropout 0, one batch of clips:

  1. the gradient of the whole batch (one process);
  2. the mean of the gradients of its ``--slices`` equal slices (what the
     ``data`` axis's all-reduce of each rank's mean gradient computes);
  3. the gradient of the same batch with its clips in reverse order (the
     same sum in another order: the yardstick of f32 rounding).

Per parameter tensor, the relative L2 of 2 and of 3 against 1. Adam's
first moment after one step is 0.1 times the gradient, so these are the
relative L2s ``chip_smoke.py``'s tp phase reads on the moments after step 1.

    python -m sd_video_gen_tpu_torch.tools.split_check [--batch 24]
        [--slices 4] [--frames square|noise] [--top 5] [--device cpu]

prints one JSON line: the worst tensors of 2 against 1, each with its
yardstick, and the largest of each over all tensors. ``square``: black
frames, a bright 32 x 32 square moving across each clip (the training data
of ``chip_smoke.py``'s data and tp phases); ``noise``: uniform uint8.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.config import strict_f32
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops.losses import LossWeights, composite_loss
from sd_video_gen_tpu_torch.tools.bench_harness import TRAIN_PATHS
from sd_video_gen_tpu_torch.train.trainer import (_predictions_and_targets,
                                                  encode_or_passthrough)

PATH = next(p for p in TRAIN_PATHS if p["name"] == "train_flagship")


def clips(kind: str, batch: int, frames: int, size: int,
          seed: int = 0) -> np.ndarray:
    """(batch, frames, size, size, 3) uint8 clips of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (batch, frames, size, size, 3),
                            dtype=np.uint8)
    # at 128px: a 32px square from (8..71, 8..71), drifting up to 40px
    out = np.zeros((batch, frames, size, size, 3), np.uint8)
    side, edge, drift = size // 4, size // 16, 5 * size // 16
    for b in range(batch):
        (y, x) = rng.integers(edge, size - side - 3 * edge, 2)
        (dy, dx) = rng.integers(-6, 7, 2)
        for t in range(frames):
            ty, tx = y + (dy * t) % drift, x + (dx * t) % drift
            out[b, t, ty:ty + side, tx:tx + side] = rng.integers(96, 256)
    return out


def gradients(model, codec, loss_w, k: int, batch) -> dict:
    """Each parameter's gradient of the batch's loss (its mean over the
    clips), as the train step computes it."""
    latents = encode_or_passthrough(codec, batch, True)
    pred, target = _predictions_and_targets(model, latents, k, "ar")
    total, _ = composite_loss(pred.float(), target.float(), loss_w)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.double()
    return float((a.double() - b).norm() / b.norm()) if b.norm() else 0.0


def check(cfg, batch: np.ndarray, slices: int, device, top: int = 5,
          seed: int = 0) -> dict:
    """The three gradients of ``batch`` under ``cfg``'s model and loss, and
    the per-tensor comparison."""
    mc = FrameTransformerConfig.from_config(cfg.replace(dropout_p=0.0),
                                            mode="ar")
    model = build(FrameTransformer, mc, device, torch.float32, seed,
                  trainable=True)
    codec = PixelCodec(cfg.frame_size, device)
    args = (model, codec, LossWeights.from_config(cfg),
            cfg.frames_to_predict)
    if len(batch) % slices:
        raise ValueError(f"{len(batch)} clips do not split in {slices}")
    whole = gradients(*args, batch)
    split = None
    for part in np.split(batch, slices):
        g = gradients(*args, part)
        split = g if split is None else {n: split[n] + v
                                         for n, v in g.items()}
    split = {n: v / slices for n, v in split.items()}
    order = gradients(*args, np.ascontiguousarray(batch[::-1]))
    rows = sorted(((_rel(split[n], v), _rel(order[n], v), n)
                   for n, v in whole.items()), reverse=True)
    return {"clips": len(batch), "slices": slices,
            "worst": [{"tensor": n, "split_rel_l2": s, "order_rel_l2": o}
                      for s, o, n in rows[:top]],
            "max_split_rel_l2": rows[0][0],
            "max_order_rel_l2": max(o for _, o, _ in rows)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=24)
    parser.add_argument("--slices", type=int, default=4)
    parser.add_argument("--frames", choices=("square", "noise"),
                        default="square")
    parser.add_argument("--frame", type=int, default=None,
                        help="frame size (default: the path's 128)")
    parser.add_argument("--top", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    strict_f32()
    cfg = PATH["cfg"].replace(batch_size=args.batch)
    if args.frame is not None:
        cfg = cfg.replace(frame_size=args.frame)
    batch = clips(args.frames, args.batch, PATH["clip_frames"],
                  cfg.frame_size)
    out = check(cfg, batch, args.slices, torch.device(args.device),
                args.top)
    out["frames"] = args.frames
    if torch.device(args.device).type == "cuda":
        out["device"] = torch.cuda.get_device_name()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
