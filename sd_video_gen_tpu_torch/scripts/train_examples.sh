#!/usr/bin/env bash
# Launch recipes for the port's trainer (the reference shipped per-machine
# scripts; one machine-agnostic script shows the equivalent launches).
# Checkpoints are the port's directories <config>_<index>_<mode>/ under
# ./checkpoints. Every entry point runs with TF32 off. Add --device cpu to
# train without a card.
set -euo pipefail

# bouncing ball, small, save-best
python -m sd_video_gen_tpu_torch.train.trainer --dataset ball \
  --config ball_complex_L1_64 --folder data/ball --save_best True "$@"

# KITTI future-frame with SD-VAE latents
# python -m sd_video_gen_tpu_torch.train.trainer --dataset kitti \
#   --config kitti_L1_64 --folder data/kitti --codec vae \
#   --vae_weights weights/sd_vae.safetensors

# UCF flagship, full grid sweep, four processes on four cards (data x model)
# torchrun --nproc_per_node 4 -m sd_video_gen_tpu_torch.train.trainer \
#   --dataset ucf --config ucf_final --sweep --multihost \
#   --mesh data=2,model=2 --flip True

# UCF text-conditioned
# python -m sd_video_gen_tpu_torch.train.trainer --dataset ucf \
#   --config ucf_text_final --train_mode text

# in-training FVD every 5 epochs (trainer_fvd role)
# python -m sd_video_gen_tpu_torch.train.trainer --dataset ucf \
#   --config ucf_final --fvd_every 5 --i3d_weights weights/i3d_400.pt

# from a native frame cache (the C++ loader; build it once with
# python -m sd_video_gen_tpu_torch.data.native_loader ... --out frame_cache)
# python -m sd_video_gen_tpu_torch.train.trainer --dataset ucf \
#   --config ucf_final --native_cache frame_cache
