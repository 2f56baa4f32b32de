"""End-to-end demo on the port: synthesise data, train, roll out, beat the
copy baseline (``examples/ball_demo.py`` beside the JAX package).

A 5M-parameter FrameTransformer (dim 256, 2 enc + 4 dec) learns bouncing
balls through the port's ``Trainer``; then a 4-frame rollout of one test
clip is scored by pixel MSE against the naive copy of the last context
frame. ``--dataset ball`` renders the JAX demo's PNG tree (needs ``cv2``);
``--dataset mnist``, for a machine without ``cv2``, draws the same kind of
motion into a Moving-MNIST-layout ``.npy`` (one 5-frame training clip per
sequence, so six times the sequences give about as many clips).

    python -m sd_video_gen_tpu_torch.examples.ball_demo [--epochs 12]
        [--size 64] [--dataset ball|mnist] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from sd_video_gen_tpu_torch.config import Config, strict_f32


def datasets(args):
    """(train, test, rollout test) datasets: 5-frame clips to train on, a
    9-frame clip (5 context + 4 to predict) to roll out."""
    from sd_video_gen_tpu_torch.data import (BouncingBallDataset,
                                             MovingMNISTDataset,
                                             generate_bouncing_ball_tree)
    if args.dataset == "ball":
        root = generate_bouncing_ball_tree(args.data_dir, n_train_seqs=40,
                                           n_test_seqs=8, frames_per_seq=30,
                                           size=args.size, seed=1)
        return (BouncingBallDataset(5, 1, root, "train", seed=0),
                BouncingBallDataset(5, 1, root, "test", seed=0),
                BouncingBallDataset(9, 1, root, "test", shuffle=False))
    from sd_video_gen_tpu_torch.tools.quality_modes import make_moving_disks
    os.makedirs(args.data_dir, exist_ok=True)
    npy = make_moving_disks(os.path.join(args.data_dir, "disks.npy"),
                            seqs=6 * 48, frames=30, size=args.size, seed=1)
    return (MovingMNISTDataset(5, 1, npy, "train", seed=0),
            MovingMNISTDataset(5, 1, npy, "test", seed=0),
            MovingMNISTDataset(9, 1, npy, "test", shuffle=False))


def main(argv=None):
    strict_f32()
    from sd_video_gen_tpu_torch.data import BatchLoader
    from sd_video_gen_tpu_torch.ops.rollout import ar_rollout
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--data_dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "sdvg_ball_demo"))
    p.add_argument("--dataset", default="ball", choices=("ball", "mnist"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    train, test, clips9 = datasets(args)
    cfg = Config(config_name="demo", lr=3e-4, batch_size=16,
                 epochs=args.epochs, frames_per_clip=5, frames_to_predict=4,
                 frame_size=args.size, dim_model=256, num_heads=8,
                 num_encoder_layers=2, num_decoder_layers=4, dropout_p=0.1,
                 use_mse=True, use_gdl=True, use_contrastive=True,
                 lambda_contrastive=0.025)
    trainer = Trainer(cfg, mode="ar", codec_kind="pixel", use_wandb=False,
                      checkpoint_dir=os.path.join(args.data_dir, "ckpt"),
                      device=args.device,
                      log_dir=os.path.join(args.data_dir, "logs"))
    # save_best=False: the rollout below judges the last epoch's weights
    hist = trainer.fit(BatchLoader(train, 16, seed=1),
                       BatchLoader(test, 16, seed=1), epochs=args.epochs,
                       save_best=False)
    trainer.logger.close()
    print(f"train_loss: {hist[0]['train_loss']:.3f} -> "
          f"{hist[-1]['train_loss']:.3f}")

    # a 4-frame rollout against the copy-last-frame baseline, pixel MSE
    codec, model = trainer.codec, trainer.model.eval()
    f = torch.from_numpy(np.asarray(clips9[0][1]))[None].to(trainer.device)
    ctx, gt = f[:, :5], f[:, 5:9].float()
    with torch.no_grad():
        preds = ar_rollout(model, codec.encode_batch(ctx, use_sos=True), 4,
                           window=5)
        dec = codec.decode_latents(preds.reshape(-1, codec.latent_dim))
    dec = dec.reshape(gt.shape).float()
    mse_model = float(torch.mean(torch.square(dec - gt)))
    naive = ctx[:, -1:].expand(-1, 4, -1, -1, -1).float()
    mse_naive = float(torch.mean(torch.square(naive - gt)))
    print(f"rollout pixel MSE: model={mse_model:.0f} "
          f"naive-copy={mse_naive:.0f} -> "
          f"{'beats baseline' if mse_model < mse_naive else 'NOT learning'}")
    return mse_model, mse_naive


if __name__ == "__main__":
    main()
