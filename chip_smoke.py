"""Drive the PyTorch port (``sd_video_gen_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--tune]

Phases (any failure ends the run with a non-zero exit; there is no CPU path):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the CUDA kernels from csrc/ with nvcc, timed
  3. kernel   the full-width models (flagship FrameTransformer + SD-v1.4
              VAE/UNet/CLIP-text, bf16, seeded random weights) are built on
              the card; a dry run of every path that reaches a kernel, with
              the plain versions, records every shape each kernel is handed
              there (the SD samplers with 2 steps: every step has the same
              shapes); flash attention and GroupNorm+SiLU are held against
              their plain PyTorch versions at each of those shapes, bf16 and
              f32, timed
              with CUDA events (plain, kernel, kernel, plain); each flash
              row also names the kernel's body (``attention.route``: wgmma
              for bf16, tf32x3 for f32), its TFLOP/s (4 BH T^2 d / time),
              its bound (f32: three TF32 products on the tensor cores, the
              CUDA-core figure printed beside it) and, for scale only,
              torch's SDPA time on the same inputs (a yardstick, not a
              port); each f32 row also times the FMA body on the same
              inputs through its C entry point (measurement only: no path
              takes it); each GroupNorm signature is checked
              in the memory format the path hands it (channels-last: the
              NHWC body, with its mode: cluster or streaming) and
              once more as a contiguous tensor (the NCHW body), each row
              with its bound
              (one read and one write at the memory rate), GB/s and
              torch's ``F.silu(F.group_norm(...))`` time in the same memory
              format (a yardstick); each wrapper's host cost per call is
              timed on a tiny shape
  4. serve    every predict path through the port's ``serve`` loop over a
              Unix socket (one warm-up batch, which compiles the path's
              predictor and decoder: one CUDA graph each, ``utils/jit.py``,
              whose warm-up and capture seconds are printed; then the
              path's requests, replays of those graphs):
              reply shapes, ``is_pred`` flags, finite latents and the exact
              launch count of each kernel are checked, warm predicted
              frames/s printed; every flash launch must have taken the
              tensor-core (wgmma) body and every GroupNorm launch the NHWC
              body. The paths (names and sizes are the JAX bench's):
              ``vae_denoise_ar4`` (B=1, 10-step DDIM tail at 512px),
              ``vae_denoise_ar4_8streams_dpmpp5`` (batch_clips=8, 5-eval
              DPM-Solver++(2M) tail, one ragged 3-clip request),
              ``pixel_ar16`` (PixelCodec, 256 clips, 16 frames, full
              rollout) and its ``_int8``, ``_kvcache`` and ``_kvcache_int8``
              variants, ``vae_ar16`` (VAE codec, 32 clips, 16 frames, no
              refiner), ``vae_denoise_native_ar4`` (8 clips, cached rollout,
              the native-resolution refiner from DDIM step 48), and one
              8-clip request each of the modes ``diff``, ``future``,
              ``learned_tgt``, ``text`` (labels in the request) and the
              ``IdentityModel`` baseline
  5. sd       the full SD pipeline at 512px, B=1, guidance 7.5, the cond
              embedding from seeded token ids: ``sd_txt2img_lms50``
              (``denoise_img_latents``, 50 LMS steps, then the decode),
              ``sd_txt2img_dpmpp20`` (20 DPM-Solver++ evaluations) and
              ``sd_img2img_ddim`` (``img_to_img`` from DDIM step 10), each
              a compiled program per stage (the first image captures them):
              launches exact, images/s and UNet calls/s printed (the UNet
              calls are counted in phase 7, on the eager image: a replay
              runs no hook)
  6. check    a full-width 512px UNet forward and VAE decode with the
              kernels against the same with the plain versions (relative
              L2); guidance 0 as a Python number (one B-batch call) against
              the uncond half of the pair; frame 1 of the cached rollout
              against frame 1 of the full rollout, and the int8 rollouts
              against the bf16 ones, at full width; the slices at small
              widths in f32 on the card (kernels) against the CPU (plain)
  7. jit      every phase-4 path and phase-5 SD path, compiled against
              eager (``utils/jit.disable_jit``) on the same inputs: the
              compiled request replays phase 4's or 5's graphs, its results
              (context, predicted latents and frames; the image) must equal
              eager's bit for bit, a result held from request 1 must be
              unchanged after request 2 on other inputs, launches by body
              equal eager's and the path's (the UNet calls of the eager SD
              image counted by a hook, each of batch 2); compiled and eager
              wall, the compiled request's device ms (CUDA events around
              it) and the idle shares printed, with each path's compile
              seconds; then the B=8 DDIM refiner's predictor (the
              benchmark's ``vae_denoise_ar4_8streams``) is captured in debug
              mode, its graph dumped (``CUDAGraph.debug_dump``) and its K1
              (``flash_fwd_wgmma``) and K2 (``gn_nhwc_cluster``, or
              ``gn_nhwc_stats`` + ``gn_nhwc_apply``) kernel nodes counted:
              they must equal the launches a request counts
  8. train    three training paths through the port's ``Trainer`` (names and
              sizes are the JAX bench's), each 2 warm-up optimizer steps, 8
              timed ones (one synchronise at the end) and one more for the
              last loss, on one fixed seeded batch with dropout on:
              ``train_flagship`` (batch 6, 5 + 5 frames of 128px, PixelCodec,
              dim 2048, 4 enc + 8 dec, MSE + GDL + BiPatchNCE, lr 1e-5,
              bf16 parameters and bf16 Adam moments), ``train_flagship_tuned``
              (the same at batch 288) and ``train_ref_artifact`` (batch 64, 5
              frames of 128px, the SD VAE in f32 with seeded weights encoding
              all 320 frames inside every step, dim 256, 6 enc + 6 dec, MSE +
              GDL, lr 1e-4, f32): steps/s, clips/s, the first and the last
              loss (finite; the last below the first for
              ``train_ref_artifact``), peak memory and the exact launch
              counts by body are printed and checked; the VAE step's flash
              launches must take the f32 tensor-core body (tf32x3).
              Before the paths, a dry
              run of the VAE step's encode records its kernel shapes and
              each is held against its plain version in f32. After them: the
              ``train_flagship`` state is saved, restored into a fresh
              ``Trainer``, and one more step on each must give equal losses
              and parameters bit for bit; ``train_flagship`` is timed once
              more with ``dropout_p = 0`` (what the dropout costs a step);
              and a small f32 VAE-codec step on the card (kernels) is held
              against the CPU (plain)
  9. eval     the entry points that read files, at full width: the files
              are made from seeds in a temporary directory (a Moving-MNIST
              ``.npy``, the config as JSON, the flagship transformer written
              with the port's checkpoint writer, the SD-v1.4 VAE and UNet
              from the port's ``tools/synthetic_checkpoint.py`` in fp16,
              the CLIP text encoder and a seeded I3D as ``.pt``);
              ``fvd_native_ar4`` (``evaluation/predict_fvd.main``: 16
              clips in batches of 8, 4
              predicted frames refined on the native latent grid from DDIM
              step 48, I3D at 224px in f32, streaming FVD) and
              ``predict_cli_denoise_ar4`` (``predict/predict.main``: the same
              clips over the cached rollout, refined at 512px from DDIM step
              40, ``--timing``): finite FVD and MSE, the warm rates, exact
              launch counts by body (their shapes join phase 3's dry run);
              ``Trainer.fvd_validation`` on ``train_flagship``'s Trainer,
              both protocols; I3D on the card against the CPU
 10. data     the training input at scale: a seeded Moving-MNIST-layout
              ``.npy`` at 128px becomes train and test frame caches through
              ``data/native_loader.main`` (the cache CLI; the ``.bin`` bytes
              are held against the dataset's clips, clips/s printed); then
              ``train_native_ucf_vae``: ``train/trainer.main`` with
              ``--native_cache`` (the C++ loader, built in phase 2) and the
              reference's UCF config ``11_27_ucf_final`` at its published
              widths, written as JSON (batch 6, 5 + 5 frames of 128px, one
              epoch, ``bf16_full``, ``--codec vae``: the frozen SD VAE in
              f32, seeded, encodes every batch inside the step): finite
              losses, a checkpoint, warm steps/s and clips/s (the steps
              after the first), host ms blocked in
              ``fl_next_batch`` a batch, and exact launches (one K1 on the
              f32 tensor-core body and 22 K2 an encoded batch, train and
              val; the
              encode's kernel shapes are held against the plain versions in
              f32 first); the same run again with ``--multihost
              --num_processes 1`` (one NCCL group): losses and the saved
              state bit-equal to the first run's, one gradient all-reduce a
              step; and a few ``--train_mode text`` steps from a labelled
              cache of a seeded 101-class dataset, whose embedder must get
              the cache header's class of every served clip
 11. tp       tensor and data parallelism, rehearsed on the one card: each
              multi-process entry point as 4 worker processes (this script
              with ``--tp-worker``, ``LOCAL_RANK=0`` so every rank takes
              the card) joined in a gloo group (NCCL refuses two ranks on
              one device; every time printed carries ``backend gloo (one
              card, host-staged)``: no NCCL speed), each held against the
              same entry point in this process: ``predict.main --mesh
              data=1,model=4 --denoise`` on phase 9's files (1 predicted
              frame; 4 clips, whose 512px VAE mid block splits its batch
              over the ranks, and 3 clips, which take the ring), predicted
              latents and frames; ``predict_fvd.main --mesh data=4``
              (``fvd_native_ar4``), FVD, MSE and the real clips'
              statistics; ``train/trainer.main --mesh data=2,model=2``
              from phase 10's frame cache at the flagship's widths, f32, 3
              steps, dropout 0 (losses and the gathered checkpoint against
              one process) and 0.1 (replicated parameters bit-equal on
              every rank). Launches per rank exact (the ring's calls run
              no kernel), every per-rank kernel signature held against the
              plain version in bf16, the dtype of every rank path that
              reaches a kernel, on the body the paths take (f32 and the
              GroupNorm NCHW body, which no rank path takes, are checked at
              every full-width shape in phase 3), the bodies those of
              phase 9
 12. quality  the port's quality evidence through the tools' ``main``, at
              their defaults on a seeded Moving-MNIST-layout stand-in
              (``--dataset mnist``: no cv2 here): ``tools/quality_modes``
              trains ``ar``, ``diff`` and ``future`` (20 epochs, dim 1024)
              and scores each against the Identity baseline with the FVD
              CLI; each must beat it on FVD and MSE (what each rollout holds
              is printed beside: mean level, share of lit pixels);
              ``future``'s parameters against ``ar``'s; then
              ``tools/dpmpp_quality_gate``: Phase A, the FVD CLI on the
              trained ``ar`` model with no refiner, the DDIM-10 tail and
              the DPM-Solver++ tails of 5 and 4 calls (bf16, native grid;
              each dpmpp arm within 15% of DDIM-10), Phase B, the drift of
              those tails against fine-step truths through the f32 UNet and
              VAE decode at 512px, 8 clips (264 UNet calls; each dpmpp arm
              within 1.2x of DDIM-10's distance from the truth); exact
              launches by body (``wgmma`` for Phase A, ``tf32x3`` for Phase
              B, every GroupNorm ``nhwc``); the gate's kernel shapes (one
              UNet call of each phase, Phase B's decode) join phase 3's dry
              run
 13. cli      the port's benchmark tools (``sd_video_gen_tpu_torch/tools/``)
              at reduced depth on a Moving-MNIST-layout stand-in: the
              predict CLI as a child process (through ``tools/counted``,
              which prints the child's launches by body) in batch mode, 2
              batches of 8 streams refined by the 10-step DDIM tail at
              512px (``bench_cli_serving``; its ``--timing`` line read), and
              as a persistent server (``--serve``: ``SERVE_READY``, then 2
              requests over the socket); the trainer CLI, 2 epochs of the
              flagship at 128px from the native cache (``bench_cli_train``;
              its metrics log read, no kernel); the knee's points
              ``train_bf16_full_b48`` and ``denoise_b16`` (1 timed request
              each: exact launches, checksums equal, no ``error`` line);
              ``bench_attention``'s six rows, the dispatcher held to the
              port's limits (3e-5 f32, 2e-2 bf16) before each is timed. The
              parent's models are freed first; every child must exit 0 with
              exact launches (a DDIM batch's 658 K1 + 2908 K2, 2 batches in
              batch mode, 3 with the server's warm-up), every K1 launch on
              ``wgmma`` / ``tf32x3`` as routed and every K2 launch ``nhwc``;
              the predict CLI and the knee's serving point run compiled (a
              replay adds what its capture counted)
 14. bench    the port's benchmark (``sd_video_gen_tpu_torch/bench.py``) in
              this process: its ten scenarios (the JAX bench's names and
              sizes), each warmed up (a serving request is one compiled
              program, captured there) and timed over BENCH_REPEATS requests
              with exact launches by body and every repeat's checksum equal
              to the warm-up's, its FLOPs counted with the plain versions;
              then, once every untraced timing is taken, one traced request
              of each (device time by kernel bucket, idle share); each
              scenario's JSON record and the aggregate after it are printed
 15. tune     only with ``--tune``: at every bf16 GroupNorm signature of the
              two 512px refiner paths, the NHWC body as planned, with each
              of its modes pinned, and the NCHW body, device time inside
              CUDA graphs

The line before the last lists the kernels as JSON (flash attention's entry
also gives its main-path launches by body and the f32 training shape's
row); the last line is ``{"ok": true, "device": {...}}``. TF32 is off for
cuDNN and matmul (``config.strict_f32``, what every entry point of the port
sets), so every f32 comparison runs in full f32 (the kernel's f32 body
splits its operands itself: its TF32 products carry f32 accuracy).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sd_video_gen_tpu_torch.config import (Config, load_config, strict_f32,
                                           write_config)
from sd_video_gen_tpu_torch.data import MovingMNISTDataset
from sd_video_gen_tpu_torch.data import native_loader
from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.evaluation import predict_fvd
from sd_video_gen_tpu_torch.evaluation.predict_fvd import load_i3d
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                     empty_prompt_ids)
from sd_video_gen_tpu_torch.models.identity import IdentityModel
from sd_video_gen_tpu_torch.models.text_embed import ClassNameEmbedder
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNetConfig
from sd_video_gen_tpu_torch.models.vae import (AttnBlock, AutoencoderKL,
                                               VAEConfig)
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops.attention import (flash_attention,
                                                  reference_attention, route)
from sd_video_gen_tpu_torch.ops import groupnorm as gn
from sd_video_gen_tpu_torch.ops.groupnorm import (groupnorm_silu,
                                                  groupnorm_silu_reference)
from sd_video_gen_tpu_torch.parallel import multihost
from sd_video_gen_tpu_torch.predict import predict as P
from sd_video_gen_tpu_torch.predict import serve as S
from sd_video_gen_tpu_torch.predict.predict import (make_decode_fn,
                                                    make_predict_fn)
from sd_video_gen_tpu_torch.tools import dpmpp_quality_gate as G
from sd_video_gen_tpu_torch.tools import quality_modes as Q
from sd_video_gen_tpu_torch.tools.bench_harness import (
    BF16_FLOPS, CONTEXT, DDIM_STEPS, F32_FLOPS, FLAGSHIP, FRAME,
    HBM_BYTES_PER_S, HI_RES, KERNELS, PATH_DEFAULTS, PATHS, REFINER_PATHS,
    SD_GUIDANCE, SD_PATHS, SD_RUNS, TF32_FLOPS, TRAIN_FRAME, TRAIN_PATHS,
    TRAIN_TIMED, TRAIN_WARMUP, assert_finite, build_models, card,
    expected_launches, full_width_models, launch_window, log, make_trainer,
    passes_per_model, predict_fn, train_frames, wrapper_host_cost)
from sd_video_gen_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     save_checkpoint)
from sd_video_gen_tpu_torch.train import trainer as T
from sd_video_gen_tpu_torch.train.optim import Adam
from sd_video_gen_tpu_torch.train.trainer import (Trainer, TrainState,
                                                  encode_or_passthrough)
from sd_video_gen_tpu_torch.utils import jit as J

# A small f32 VAE-codec train step, card (kernels) vs CPU (plain), dropout
# off: loss components relative, first moments (the gradient) relative L2.
# Summation order only (TF32 off).
SMALL_TRAIN_LOSS_RTOL = 1e-4
SMALL_TRAIN_GRAD_REL_L2 = 1e-3
TEXT_CLASSES, TEXT_DIM = 101, 384
# Kernel vs its plain version computed in f32 from the same inputs.
# flash attention, max abs: f32, the FMA body's order over up to 4096 keys;
# bf16: p is rounded to bf16 before p.v and the output to bf16, as in the
# TPU kernel.
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The f32 tensor-core body (three TF32 products) has a limit of its own,
# 3x its worst reading on the card (9.42e-6): dropping any one of its four
# cross terms leaves 4.6e-5 or more in exact sums
# (tests/test_torch_attention.py), so 1e-4 alone would not catch it.
TF32X3_ATOL = 3e-5
# GroupNorm+SiLU, |out - ref| <= rtol |ref| + atol: f32, the same two-pass
# statistics summed in another order; bf16, the one final rounding (half an
# ulp, 2^-9 relative) plus that f32 noise.
GN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -8, 1e-5)}
# bf16 512px forwards, both kernels vs both plain versions: both round to
# bf16 at the same places but sum in other orders, and one-ulp differences
# pass through every norm, attention layer and the residual stream. The
# floor, over 3 seeds (x 3 timesteps for the UNet), is the plain model
# against itself with only attention's p kept in f32, or with torch's own
# bf16 GroupNorm + SiLU: UNet 1.03e-2 to 1.06e-2 and 1.26e-2 to 1.30e-2
# (kernels 1.04e-2 to 1.07e-2); VAE decode 2.11e-2 to 2.12e-2 and 2.79e-2
# to 2.83e-2 (kernels 2.11e-2 to 2.13e-2) (PERF.md, Findings).
UNET_REL_L2 = 2e-2
VAE_REL_L2 = 4e-2
# f32 slice at small widths, card vs CPU: summation order only (TF32 off),
# but frames pass through uint8 twice per refine, so a value on a rounding
# boundary may flip a level and move the re-encoded latent.
SMALL_LATENT_ATOL = 1e-3
# int8 at small widths, card vs CPU: a value on a rounding boundary may take
# another int8 step on the other device, worth 1/127 of its token's largest
# value in one product.
SMALL_INT8_ATOL = 5e-2
# Frame 1 of the cached rollout against the full rollout's in f32: summation
# order only.
SMALL_CACHED_FRAME1_REL_L2 = 1e-4
SMALL_PIXEL_FLIP_SHARE = 0.01
# Guidance 0 as one B-batch UNet call against the uncond half of the 2B-batch
# pair, bf16 at 512px: the same arithmetic at another batch size, so cuDNN
# and cuBLAS may pick other algorithms and sum in other orders: the bf16
# rounding floor of the UNet again (UNET_REL_L2).
# Frame 1 of the cached rollout against frame 1 of the full rollout, bf16 at
# full width: the same mathematics, but the cached path keeps the JAX
# package's f32 layer norms and residual adds where the module rounds each
# to bf16, through 4 + 8 layers: relative L2.
CACHED_FRAME1_REL_L2 = 5e-2
# The int8 rollouts against the bf16 ones, first predicted frame, relative
# L2: per-token int8 activations and per-channel int8 weights (1/127 steps)
# through 12 layers; the JAX package's own tests hold int8 to "a few
# percent" of the float forward at small widths.
INT8_REL_L2 = 0.15
# The evaluation paths (phase 9), entry points that read files as a user's
# run does: ``fvd_native_ar4`` is ``evaluation/predict_fvd.main`` with the
# native-resolution refiner from DDIM step 48 (the JAX bench's
# ``vae_denoise_native_ar4`` under the FVD CLI's defaults);
# ``predict_cli_denoise_ar4`` is ``predict/predict.main`` over the cached
# rollout, whose refiner runs at 512px from DDIM step 40, as the JAX
# package's predict CLI does by default. Both: the flagship transformer
# restored from a checkpoint directory, the SD-v1.4 VAE, UNet and CLIP from
# weight files, 16 Moving-MNIST-layout clips of 64px in batches of 8, 4
# predicted frames (5 + 4 = 9, I3D's minimum).
EVAL_CONFIG, EVAL_CLIPS = "eval_flagship", 16
EVAL_PATHS = [dict(PATH_DEFAULTS, **p) for p in (
    dict(name="fvd_native_ar4", codec="vae", batch_clips=8,
         refine=dict(hi_res=None, start_step=48, sampler="ddim",
                     solver_steps=None)),
    dict(name="predict_cli_denoise_ar4", codec="vae", batch_clips=8,
         rollout="cached",
         refine=dict(hi_res=HI_RES, start_step=40, sampler="ddim",
                     solver_steps=None)))]
# I3D on the card against the CPU, the same weights and one (2, 9, 224,
# 224, 3) batch, logits relative L2. Both sides f32 with TF32 off, so only
# summation order differs (and cuDNN's choice of algorithm): the CPU tests
# hold the port's I3D against the JAX package's within 2e-4 of the logits'
# largest value.
I3D_REL_L2 = 1e-4
I3D_SHAPE = (2, 9, 224, 224, 3)
# The data phase (phase 10): the reference's UCF config, every value of
# configs/11_27_ucf_final.yml but two: one epoch, and clips of 10 frames (its
# 5 context frames and the 5 to predict, as ``train_flagship``'s batch
# holds them). The frames: a Moving-MNIST-layout .npy of DATA_SEQS
# sequences at 128px (cv2 is not promised here), 80% of them train clips:
# 12 train batches of 6 and 3 val batches.
DATA_CONFIG, DATA_SEQS, DATA_FRAMES = "11_27_ucf_final", 96, 10
DATA_YML = {"LR": [1e-5], "BATCH_SIZE": [6], "EPOCHS": [1],
            "EPOCH_RATIO": [1], "NUM_WORKERS": [12],
            "FRAMES_PER_CLIP": [DATA_FRAMES], "FRAMES_TO_PREDICT": [5],
            "STRIDE": [1], "FPS": [3], "FRAME_SIZE": TRAIN_FRAME,
            "DIM_MODEL": [FLAGSHIP["dim_model"]],
            "NUM_HEADS": [FLAGSHIP["num_heads"]],
            "NUM_ENCODER_LAYERS": [FLAGSHIP["num_encoder_layers"]],
            "NUM_DECODER_LAYERS": [FLAGSHIP["num_decoder_layers"]],
            "DROPOUT_P": [0.1], "USE_MSE": [True], "USE_GDL": [True],
            "LAMBDA_GDL": [1], "ALPHA": [1], "USE_CONTRASTIVE": [True],
            "LAMBDA_CONTRASTIVE": [0.025]}
# The text-mode path: a labelled cache of a seeded in-script dataset of
# TEXT_CLASSES classes (train and test clips), PixelCodec.
DATA_TEXT_CLIPS = (24, 12)
FLASH_BODIES = ("wgmma", "tf32x3", "fma")
# Flash launches by body over the main path's counted windows (``counted``).
BODY_LAUNCHES: collections.Counter = collections.Counter()
# Phase 4's compiled entry points by path name, replayed by phase ``jit``.
SERVED: dict = {}
# Phase jit: the path whose compiled request's CUDA graph is dumped
# (``CUDAGraph.debug_dump``) and its kernel nodes counted: the B=8 DDIM
# refiner of the benchmark's ``vae_denoise_ar4_8streams``.
JIT_DUMP_STREAMS = 8
# The flash rows of the f32 training step's dry run (phase 8), for the
# kernels line.
TRAIN_F32_ROWS: list = []


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after warm-up."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(plain, kern) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain with as many
    launches as fill about 10 ms of the plain version (3 to 100): CUDA
    events resolve such a window to well under 1%."""
    iters = int(min(100, max(3, 10.0 / max(cuda_ms(plain, 1), 1e-3))))
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device() -> str:
    smi = card()
    log(smi)
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return smi


def phase_build():
    """The CUDA kernels and, beside them in a thread of its own, the C++
    frame loader (g++): a build failure ends the run here."""
    t0 = time.perf_counter()
    loader = {}

    def build_loader():
        try:
            native_loader._load_lib()
            loader["seconds"] = time.perf_counter() - t0
        except Exception as e:  # re-raised below, in this thread
            loader["error"] = e

    thread = threading.Thread(target=build_loader)
    thread.start()
    try:
        _kernels.library()
    finally:
        thread.join()
    if "error" in loader:
        raise loader["error"]
    log(f"build: {_kernels.BUILD['path']} nvcc {_kernels.BUILD['seconds']:.2f} s"
        f" (load included {time.perf_counter() - t0:.2f} s); frame loader "
        f"{native_loader.library_path()} built or loaded in "
        f"{loader['seconds']:.2f} s")


def mode_models(models, ft_dims, text_dim=TEXT_DIM):
    """``models`` plus the transformers of the other modes (same widths; the
    text model is ``dim_model + text_dim`` wide) and the identity baseline."""
    L = models["ar"].cfg.latent_dim
    out = dict(models, identity=IdentityModel())
    for seed, mode in enumerate(("future", "learned_tgt", "text"), start=4):
        out[mode] = build(FrameTransformer, FrameTransformerConfig(
            latent_dim=L, mode=mode, frames_to_predict=5,
            text_embed_dim=text_dim, **ft_dims),
            models["device"], models["dtype"], seed=seed)
    return out


def sd_inputs(models):
    """The SD paths' pipeline, [uncond; cond] embeddings (the cond half from
    seeded token ids between BOS and EOS: the tokenizer's files are not in
    the repository) and a seeded 512px uint8 image."""
    pipe = SDPipeline(models["vae"], models["unet"], models["clip"])
    rng = np.random.default_rng(7)
    ids = empty_prompt_ids(1, pipe.clip.cfg.max_length, pipe.device)
    ids[0, 1:9] = torch.from_numpy(rng.integers(0, 49406, 8)).to(ids)
    with torch.inference_mode():
        emb = torch.cat([pipe.uncond_embeddings(1)[:1], pipe.clip(ids)])
    img = rng.integers(0, 256, (1, HI_RES, HI_RES, 3), dtype=np.uint8)
    return pipe, emb, img


def run_sd(pipe, path, emb, img, steps=None, seed=0):
    """One image through an SD path -> (1, 512, 512, 3) uint8. ``steps``
    cuts the sampler short (the dry run): that many UNet calls."""
    g = torch.Generator(device=pipe.device).manual_seed(seed)
    if path["sampler"] == "ddim":
        start = path["start_step"] if steps is None else path["steps"] - steps
        return pipe.img_to_img([""], img, HI_RES, HI_RES, path["steps"],
                               SD_GUIDANCE, start_step=start, generator=g)
    lat = pipe.denoise_img_latents(emb, HI_RES, HI_RES, steps or path["steps"],
                                   SD_GUIDANCE, generator=g,
                                   sampler=path["sampler"])
    return pipe._decode_pixels(assert_finite("denoised latents", lat))


def path_signatures(models):
    """Every (kernel, signature) each path that reaches a kernel hands the
    dispatchers, with its number of calls in one batch (predict + the final
    decode, what ``serve`` runs) or one image: a dry run with the plain
    versions; the SD samplers with 2 steps. By path name."""
    t0 = time.perf_counter()
    pipe, emb, img = sd_inputs(models)
    by_path = {}
    with _kernels.force_reference(), torch.inference_mode():
        for path in PATHS:
            if path["codec"] != "vae" and path["refine"] is None:
                continue
            with _kernels.record_calls() as rec:
                codec, predict = predict_fn(models, path)
                context, preds = predict(np.zeros(
                    (path["batch_clips"], CONTEXT, FRAME, FRAME, 3),
                    np.uint8))
                seq = torch.cat([context[:, :-1], preds], dim=1)
                codec.decode_latents(seq.reshape(-1, seq.shape[-1]))
            by_path[path["name"]] = rec.calls
        for path in SD_PATHS:
            with _kernels.record_calls() as rec:
                run_sd(pipe, path, emb, img, steps=2)
            by_path[path["name"]] = rec.calls
    torch.cuda.synchronize()
    merged = merge_signatures(by_path.values())
    n = {k: sum(1 for name, _ in merged if name == k) for k in KERNELS}
    log(f"kernel: dry run of {len(by_path)} paths (plain versions) in "
        f"{time.perf_counter() - t0:.1f} s: {n} distinct signatures")
    return by_path


def merge_signatures(counters) -> collections.Counter:
    """The calls of several dry runs by (kernel, signature), the dtype a
    path handed left out (``None``): phase 3 checks every shape in bf16 and
    f32 alike."""
    merged = collections.Counter()
    for calls in counters:
        for (name, sig), n in calls.items():
            merged[(name, (sig[0], None, *sig[2:]))] += n
    return merged


def fma_body(q, k, v, scale):
    """The f32 FMA body through its C entry point (dtype code 0), for timing
    beside the body the path takes; not counted (no path launches it)."""
    out = torch.empty_like(q)
    err = _kernels.library().sdvg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.shape, float(scale), 0, torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "flash_attention (fma, timed)")
    return out


def split_tf32(x):
    """(big, small) of f32 ``x`` as the f32 tensor-core body splits it: big
    = tf32(x), small = tf32(x - big), rounded to nearest with ties away
    (half a TF32 ulp added to the bits, the 13 low ones cleared)."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def tensor_core_split_attention(q, k, v, scale):
    """Attention with both products made of the f32 body's three TF32
    products (big * small, small * big, big * big) in one accumulator, but
    by cuBLAS on the tensor cores (TF32 on; the parts side by side along
    the contraction), 8 heads at a time. Measurement only: its distance
    from the plain version is the tensor cores' own f32 accumulation, to
    set beside the body's."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = torch.empty_like(q)
        for h in range(0, q.shape[0], 8):
            qb, qs = split_tf32(q[h:h + 8])
            kb, ks = split_tf32(k[h:h + 8])
            vb, vs = split_tf32(v[h:h + 8])
            s = torch.cat([qb, qs, qb], -1) @ torch.cat(
                [ks, kb, kb], -1).transpose(1, 2) * scale
            p = torch.exp(s - s.amax(-1, keepdim=True))
            del s
            pb, ps = split_tf32(p)
            out[h:h + 8] = torch.cat([ps, pb, pb], -1) @ torch.cat(
                [vb, vs, vb], 1) / p.sum(-1, keepdim=True)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def tensor_core_rounding() -> float:
    """Share of the tensor cores' f32 sums (cuBLAS, TF32 on, 512 x 512 x
    512, TF32-exact operands so every product is exact) that land nearer
    zero than the exact sum, among those that differ from it: about 0.5
    for rounding to nearest, 1 for truncation."""
    g = torch.Generator(device="cuda").manual_seed(1)
    a, b = (split_tf32(torch.randn(512, 512, generator=g, device="cuda"))[0]
            for _ in range(2))
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = (a @ b).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    exact = a.double() @ b.double()
    off = got != exact
    return ((got.abs() < exact.abs()) & off).sum().item() / off.sum().item()


def check_attention(sig, dtype) -> dict:
    shape, _, scale = sig
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    out = flash_attention(q, k, v, scale)
    ref = reference_attention(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.float32:
        tc_err = (tensor_core_split_attention(q, k, v, scale) - ref
                  ).abs().max().item()
    del out, ref
    ms, plain_ms = timed(lambda: reference_attention(q, k, v, scale),
                         lambda: flash_attention(q, k, v, scale))
    # For scale only: torch's fused attention on the same inputs, as
    # (1, BH, T, d) so that its fused backends may take it.
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], scale=scale), 20)
    BH, T, d = shape
    ops = 4 * BH * T * T * d
    # least time: both products at the best rate the card has for the type,
    # or q, k, v read and the output written once. f32-accurate products:
    # three TF32 products on the tensor cores (165 TFLOP/s of f32 work,
    # beating the CUDA cores' 67).
    flops_ms = (ops / BF16_FLOPS if dtype == torch.bfloat16
                else 3 * ops / TF32_FLOPS) * 1e3
    bytes_ms = 4 * q.numel() * q.element_size() / HBM_BYTES_PER_S * 1e3
    body = route(dtype, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    extra = {}
    if dtype == torch.float32:
        extra = dict(cuda_core_ms=ops / F32_FLOPS * 1e3, tc_err=tc_err,
                     fma_ms=cuda_ms(lambda: fma_body(q, k, v, scale),
                                    max(3, min(20, int(25 / ms)))))
    atol = TF32X3_ATOL if body == "tf32x3" else ATTN_ATOL[dtype]
    return dict(max_abs_err=err, ok=err <= atol, ms=ms,
                plain_ms=plain_ms, route=body,
                tflops=ops / ms / 1e9, library_ms=sdpa_ms,
                bound_ms=max(flops_ms, bytes_ms),
                bound_by="operations" if flops_ms >= bytes_ms else "bytes",
                **extra)


def check_groupnorm(sig, dtype, body) -> dict:
    """One GroupNorm signature on ``body``: ``"nhwc"`` makes the tensor
    channels-last, ``"nchw"`` contiguous; ``route`` must agree."""
    shape, _, groups, eps, silu, _ = sig
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    if body == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    if gn.route(x) != body:
        raise AssertionError(f"groupnorm route {gn.route(x)} for a {body} "
                             f"tensor of shape {shape}")
    C = shape[1]
    w = (1 + 0.5 * torch.randn(C, generator=g, device="cuda")).to(dtype)
    b = (0.5 * torch.randn(C, generator=g, device="cuda")).to(dtype)
    out = groupnorm_silu(x, w, b, groups, eps, silu)
    if out.stride() != x.stride():
        raise AssertionError(f"groupnorm_silu changed the memory format: "
                             f"{x.stride()} -> {out.stride()}")
    ref = groupnorm_silu_reference(x.float(), w.float(), b.float(), groups,
                                   eps, silu)
    diff = (out.float() - ref).abs()
    rtol, atol = GN_TOL[dtype]
    ok = bool((diff <= rtol * ref.abs() + atol).all())
    err = diff.max().item()
    del out, ref, diff
    ms, plain_ms = timed(
        lambda: groupnorm_silu_reference(x, w, b, groups, eps, silu),
        lambda: groupnorm_silu(x, w, b, groups, eps, silu))
    # For scale only: torch's own ops on the same tensor (same memory format).
    library_ms = cuda_ms(lambda: F.silu(F.group_norm(x, groups, w, b, eps))
                         if silu else F.group_norm(x, groups, w, b, eps), 10)
    nbytes = 2 * x.numel() * x.element_size()    # one read, one write
    mode = ""
    if body == "nhwc":
        plan = gn.nhwc_plan(shape[0], C, shape[2] * shape[3], groups, dtype)
        mode = {"cluster": f"{plan['blocks']} clusters of {plan['cluster']}",
                "streaming": f"streaming, {plan['blocks']} stat blocks a "
                             f"unit"}[plan["mode"]]
        mode += f", {plan['groups_per_unit']} groups per unit"
    return dict(max_abs_err=err, ok=ok, ms=ms, plain_ms=plain_ms, route=body,
                mode=mode, library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                gbps=nbytes / ms / 1e6)


def log_wrapper_host_cost():
    """Host time per wrapper call (``bench_harness.wrapper_host_cost``)."""
    for (name, body), host in wrapper_host_cost().items():
        shape = ("(1, 32, 8, 8) bf16" if name == "groupnorm_silu" else
                 f"(1, 64, 40) {'bfloat16' if body == 'wgmma' else 'float32'}")
        log(f"kernel: {name} wrapper on {shape} {body}: {host * 1e6:.2f} us "
            f"of host time per call, {1 / host:.0f} calls/s")


def check_signatures(sigs, dtypes, what: str = "", nchw: bool = True
                     ) -> list:
    """Each kernel at each signature of ``sigs`` in each of ``dtypes``
    against its plain version, timed; fails on any disagreement.
    ``nchw=False`` leaves out the GroupNorm NCHW body, which no path
    takes."""
    rows, failures = [], []
    for (name, sig), calls in sigs.items():
        if name == "groupnorm_silu" and sig[5] != "nhwc":
            raise AssertionError(f"the dry run handed GroupNorm a {sig[5]} "
                                 f"tensor {sig[0]}: the models left "
                                 f"channels-last")
        # the path's own body first, then the NCHW body on the same shape
        # (not at C = 1 or H = W = 1: both layouts are the same memory there
        # and ``route`` gives it to the NHWC body)
        bodies = (None,)
        if name == "groupnorm_silu":
            one_layout = sig[0][1] == 1 or sig[0][2] * sig[0][3] == 1
            bodies = ("nhwc",) if one_layout or not nchw else ("nhwc",
                                                                "nchw")
        for dtype in dtypes:
            for body in bodies:
                res = (check_attention(sig, dtype) if body is None else
                       check_groupnorm(sig, dtype, body))
                row = dict(kernel=name, shape=list(sig[0]),
                           args=[str(a) for a in sig[2:5]],
                           dtype=str(dtype).split(".")[-1], calls=calls,
                           on_path=body != "nchw", **res)
                rows.append(row)
                extra = (f", {row['tflops']:.1f} TFLOP/s" + (
                    f"; FMA body {row['fma_ms']:.4f} ms (this body "
                    f"{row['fma_ms'] / row['ms']:.2f}x faster), CUDA-core "
                    f"bound {row['cuda_core_ms']:.4f} ms; the three TF32 "
                    f"products by cuBLAS on the tensor cores: err "
                    f"{row['tc_err']:.2e}"
                    if "fma_ms" in row else "")
                         if name == "flash_attention" else
                         f" ({row['mode']}), {row['gbps']:.0f} GB/s"
                         if row["mode"] else f", {row['gbps']:.0f} GB/s")
                log(f"kernel: {what}{name} {tuple(sig[0])} {row['args']} "
                    f"{row['dtype']} x{calls}: err {row['max_abs_err']:.2e} "
                    f"{'ok' if row['ok'] else 'FAIL'}, {row['ms']:.4f} ms, "
                    f"plain {row['plain_ms']:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                    f"{row['bound_ms'] / row['ms']:.0%} of it reached), "
                    f"library (yardstick, not a port) "
                    f"{row['library_ms']:.4f} ms, route {row['route']}"
                    f"{extra}")
                if not row["ok"]:
                    failures.append(row)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return rows


def phase_kernel(sigs) -> dict:
    log(f"kernel: tensor cores' f32 sums of exact TF32 products (cuBLAS, "
        f"TF32 on): {tensor_core_rounding():.4f} of those off the exact sum "
        f"lie nearer zero")
    rows = check_signatures(sigs, (torch.bfloat16, torch.float32))
    log_wrapper_host_cost()
    summary = {}
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        # times: the bf16 shape with the most kernel time in one batch of
        # every path, on the path's body; error: the worst over all rows
        hot = max((r for r in mine if r["dtype"] == "bfloat16"
                   and r["on_path"]), key=lambda r: r["calls"] * r["ms"])
        summary[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in mine),
            **{k: hot[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")})
        total = sum(r["calls"] * r["ms"] for r in mine
                    if r["dtype"] == "bfloat16" and r["on_path"])
        log(f"kernel: {name} summary times at {hot['shape']} {hot['args']} "
            f"bf16 (most kernel time per batch), {len(mine)} rows; bf16 "
            f"calls x ms over one batch of every path: {total:.1f} ms")
    return summary


def counted(window) -> dict:
    """A main-path window's launches, its flash launches by body added to
    ``BODY_LAUNCHES``."""
    BODY_LAUNCHES.update(window.bodies)
    return window.launches


def log_compiles(name, compiles) -> None:
    """Each compile's seconds (``utils/jit.COMPILES``): warm-up, capture."""
    for c in compiles:
        log(f"{name}: compiled {c['name']} {c['shapes']}: warm-up "
            f"{c['warmup_s']:.3f} s + capture {c['capture_s']:.3f} s; the "
            f"graph's launches {c['graph_launches']}")


def phase_serve(models, path) -> dict:
    name, batch_clips, pred = path["name"], path["batch_clips"], path["pred"]
    codec, predict = predict_fn(models, path, checked=True)
    decode = make_decode_fn(codec)
    embedder = (ClassNameEmbedder(TEXT_CLASSES, TEXT_DIM,
                                  device=models["device"])
                if path["labels"] else None)
    n_compiles = len(J.COMPILES)
    sock_dir = tempfile.TemporaryDirectory(prefix="sdvg")
    sock = os.path.join(sock_dir.name, "serve.sock")
    if len(sock) > 100:
        raise RuntimeError(f"socket path too long for AF_UNIX: {sock}")
    errors = []

    def run_server():
        try:
            S.serve(sock, predict, decode, batch_clips=batch_clips,
                    frames_per_clip=CONTEXT, frame_size=FRAME,
                    embedder=embedder)
        except Exception as e:  # re-raised by the main thread below
            errors.append(e)

    replies = []
    with launch_window() as window:               # the main path
        t_start = time.perf_counter()
        server = threading.Thread(target=run_server, daemon=True)
        server.start()
        try:
            while True:  # the warm-up batch runs before the socket exists
                if errors or not server.is_alive():
                    raise RuntimeError(f"serve loop stopped before it was "
                                       f"ready: {errors}")
                try:
                    S.ping(sock)
                    break
                except OSError:
                    time.sleep(0.2)
            log(f"{name}: server ready after "
                f"{time.perf_counter() - t_start:.1f} s (warm-up batch "
                f"included)")
            rng = np.random.default_rng(0)
            for i, clips in enumerate(path["requests"]):
                frames = rng.integers(
                    0, 256, (clips, CONTEXT, FRAME, FRAME, 3), dtype=np.uint8)
                labels = (rng.integers(0, TEXT_CLASSES, clips).tolist()
                          if path["labels"] else None)
                t1 = time.perf_counter()
                imgs, is_pred, _ = S.request(sock, frames, labels,
                                             timeout_s=600)
                wall = time.perf_counter() - t1
                replies.append((clips, imgs, is_pred, wall))
                log(f"{name}: request {i} ({clips} clips at batch_clips="
                    f"{batch_clips}): {list(imgs.shape)} {imgs.dtype}, "
                    f"{wall:.3f} s, {clips * pred / wall:.3f} predicted "
                    f"frames/s")
        finally:
            if server.is_alive():
                S.shutdown(sock)
            server.join(timeout=120)
            sock_dir.cleanup()
    if errors:
        raise errors[0]
    if server.is_alive():
        raise RuntimeError("serve loop did not stop")

    want_flags = [False] * (CONTEXT - 1) + [True] * pred
    for clips, imgs, is_pred, _ in replies:
        want_shape = (clips, CONTEXT - 1 + pred, FRAME, FRAME, 3)
        if (imgs.shape != want_shape or imgs.dtype != np.uint8
                or is_pred != want_flags):
            raise AssertionError(f"reply {imgs.shape} {imgs.dtype} "
                                 f"{is_pred}; expected {want_shape} uint8 "
                                 f"{want_flags}")
    window.check(name, expected_launches(models, path,
                                         1 + len(path["requests"])))
    full = [c * pred / w for c, _, _, w in replies if c == batch_clips]
    log(f"{name}: warm predicted frames/s at B={batch_clips}: {full} (mean "
        f"{float(np.mean(full)):.4f}); total "
        f"{time.perf_counter() - t_start:.1f} s")
    compiles = J.COMPILES[n_compiles:]
    log_compiles(name, compiles)
    if [c["name"] for c in compiles] != ["predict_impl", "decode_impl"]:
        raise AssertionError(f"{name}: the serving shape compiled "
                             f"{[c['name'] for c in compiles]}, not once "
                             f"predict_impl and decode_impl")
    SERVED[name] = dict(codec=codec, predict=predict, decode=decode,
                        embedder=embedder, compiles=compiles)
    return counted(window)


def sd_launches(models, path) -> dict:
    """Launches of one image of an SD path: the UNet calls and the decode;
    img2img encodes first."""
    return {k: path["unet_calls"] * un + dec
            + (enc if path["sampler"] == "ddim" else 0)
            for k, (enc, dec, un) in passes_per_model(models).items()}


def phase_sd(models) -> tuple:
    """The three SD paths, each ``SD_RUNS`` images (the first a warm-up,
    which compiles the path's programs); returns their launches and the
    pipeline with its inputs (phase ``jit`` replays the same programs)."""
    pipe, emb, img = sd_inputs(models)
    total, compiles = {k: 0 for k in KERNELS}, {}
    for path in SD_PATHS:
        name, walls = path["name"], []
        n_compiles = len(J.COMPILES)
        with launch_window() as window:       # the main path
            for run in range(SD_RUNS):
                t0 = time.perf_counter()
                out = run_sd(pipe, path, emb, img, seed=run)
                pixels = out.cpu().numpy()
                walls.append(time.perf_counter() - t0)
                if (pixels.shape != (1, HI_RES, HI_RES, 3)
                        or pixels.dtype != np.uint8
                        or pixels.min() == pixels.max()):
                    raise AssertionError(
                        f"{name}: image {pixels.shape} {pixels.dtype}, "
                        f"levels {pixels.min()}..{pixels.max()}")
        calls = path["unet_calls"]
        window.check(name, {k: SD_RUNS * n
                            for k, n in sd_launches(models, path).items()})
        compiles[name] = J.COMPILES[n_compiles:]
        log_compiles(name, compiles[name])
        warm = walls[1:]
        log(f"{name}: {calls} UNet calls of batch 2 an image (counted on the "
            f"eager request in phase jit: a replay runs no hook); walls "
            f"{[round(w, 3) for w in walls]} s (the first a warm-up); warm "
            f"images/s {[round(1 / w, 4) for w in warm]} (mean "
            f"{float(np.mean([1 / w for w in warm])):.4f}), UNet calls/s "
            f"{float(np.mean([calls / w for w in warm])):.2f}")
        for k, n in counted(window).items():
            total[k] += n
    return total, (pipe, emb, img, compiles)


def _rel_l2(fn) -> tuple[float, float, float]:
    """Relative L2 of ``fn()`` with the kernels against the plain versions,
    and each one's device ms."""
    out = fn()
    with _kernels.force_reference():
        ref = fn()
    torch.cuda.synchronize()
    assert_finite("output", out)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    ms = cuda_ms(fn, 5)
    with _kernels.force_reference():
        ms_ref = cuda_ms(fn, 5)
    return rel, ms, ms_ref


def _first_frames(models, names, frames) -> dict:
    """Predicted frame 1 of each named path on the same frames."""
    by_name = {p["name"]: p for p in PATHS}
    out = {}
    for name in names:
        _, predict = predict_fn(models, by_name[name], frame=frames.shape[2],
                                 pred=2)
        out[name] = assert_finite(name, predict(frames)[1][:, 0]).float()
    return out


def _check_rollout_variants(models, frames, what, cached_bound, int8_bound):
    """Frame 1 of the cached rollout against the full rollout's, and the int8
    rollouts against the float ones, relative L2."""
    first = _first_frames(models, ("pixel_ar16", "pixel_ar16_kvcache",
                                   "pixel_ar16_int8",
                                   "pixel_ar16_kvcache_int8"), frames)
    rel = lambda a, b: ((first[a] - first[b]).norm()
                        / first[b].norm()).item()
    cached = rel("pixel_ar16_kvcache", "pixel_ar16")
    int8 = {n: rel(n, "pixel_ar16") for n in ("pixel_ar16_int8",
                                               "pixel_ar16_kvcache_int8")}
    log(f"check: {what}: frame 1 of the cached rollout vs the full rollout, "
        f"rel L2 {cached:.3e} (bound {cached_bound}); int8 vs float "
        + ", ".join(f"{n} {v:.3e}" for n, v in int8.items())
        + f" (bound {int8_bound})")
    if not (cached <= cached_bound and max(int8.values()) <= int8_bound):
        raise AssertionError(f"{what}: rollout variants disagree")


def phase_check(models):
    dev = torch.device("cuda")
    vae, unet = models["vae"], models["unet"]
    pipe, emb, _ = sd_inputs(models)
    g = torch.Generator(device=dev).manual_seed(5)
    sample = torch.randn(1, 4, HI_RES // 8, HI_RES // 8, generator=g,
                         device=dev)
    t = torch.tensor([981.0], device=dev)
    ctx = pipe.uncond_embeddings(1)[:1]
    with torch.inference_mode():
        for what, fn, bound in (
                ("UNet forward", lambda: unet(sample, t, ctx), UNET_REL_L2),
                ("VAE decode", lambda: vae.decode(sample), VAE_REL_L2)):
            rel, ms, ms_ref = _rel_l2(fn)
            log(f"check: {HI_RES}px {what} bf16, kernels vs plain: rel L2 "
                f"{rel:.3e} (bound {bound}); {ms:.2f} ms with the kernels, "
                f"{ms_ref:.2f} ms plain")
            if not rel <= bound:
                raise AssertionError(f"{what} with the kernels: rel L2 {rel} "
                                     f"> {bound}")
        # guidance 0 as a Python number: one B-batch call, the uncond half
        batches = []
        hook = unet.register_forward_pre_hook(
            lambda m, args: batches.append(args[0].shape[0]))
        try:
            zero = pipe._unet_eps(sample, 981.0, emb, 0.0)
            pair = unet(torch.cat([sample, sample]), t.expand(2), emb)
            guided = pipe._unet_eps(sample, 981.0, emb, SD_GUIDANCE)
        finally:
            hook.remove()
        rel = ((zero - pair[:1]).norm() / pair[:1].norm()).item()
        cfg = pair[:1] + SD_GUIDANCE * (pair[1:] - pair[:1])
        rel_cfg = ((guided - cfg).norm() / cfg.norm()).item()
        log(f"check: guidance 0 (a Python number) ran UNet batches "
            f"{batches[:1]}, guidance {SD_GUIDANCE} {batches[2:]}; B-batch "
            f"call vs the uncond half of the pair: rel L2 {rel:.3e} (bound "
            f"{UNET_REL_L2}); guided eps vs the pair combined by hand: "
            f"{rel_cfg:.3e}")
        if batches != [1, 2, 2] or not rel <= UNET_REL_L2 or rel_cfg > 1e-6:
            raise AssertionError("guidance: wrong UNet batches or the "
                                 "B-batch call left the pair's uncond half")

    frames = np.random.default_rng(1).integers(
        0, 256, (8, CONTEXT, FRAME, FRAME, 3), dtype=np.uint8)
    _check_rollout_variants(models, frames, "bf16 at full width",
                            CACHED_FRAME1_REL_L2, INT8_REL_L2)

    # The slices at small widths in f32: on the card with the kernels,
    # against the same weights and noise on the CPU with the plain versions
    # (what the CPU tests hold against the JAX package). 16px frames: a VAE
    # latent of 8 x 8 x 4 = 256, a pixel latent of 16.
    noise = lambda step, shape: torch.randn(
        shape, generator=torch.Generator().manual_seed(step))
    small_ft = dict(dim_model=64, num_heads=4, num_encoder_layers=1,
                    num_decoder_layers=2, dim_feedforward=64)
    base = build_models(
        "cpu", torch.float32,
        VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                  norm_num_groups=8),
        UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                   attention_heads=2, cross_attention_dim=32,
                   norm_num_groups=8),
        CLIPTextConfig(hidden_size=32, num_layers=1, num_heads=2,
                       intermediate_size=64), small_ft, 16)
    pixel = mode_models(dict(base, ar=build(
        FrameTransformer, FrameTransformerConfig(latent_dim=16, **small_ft),
        "cpu", seed=3)), small_ft, text_dim=8)
    on_cpu = {"vae": base, "pixel": pixel}
    on_card = {codec: dict({k: copy.deepcopy(m).to(dev)
                            for k, m in ms.items()
                            if isinstance(m, nn.Module)},
                           device=dev, dtype=torch.float32)
               for codec, ms in on_cpu.items()}
    frames = np.random.default_rng(1).integers(
        0, 256, (2, CONTEXT, 16, 16, 3), dtype=np.uint8)
    labels = [3, 77]
    for path in PATHS:
        out = {}
        for where, sets in (("cpu", on_cpu), ("gpu", on_card)):
            ms = sets[path["codec"]]
            codec, predict = predict_fn(ms, path, 16, 64, 3, noise_fn=noise)
            before = dict(_kernels.LAUNCHES)
            extra = ((ClassNameEmbedder(TEXT_CLASSES, 8, device=ms["device"])(
                labels),) if path["labels"] else ())
            ctx, preds = predict(frames, *extra)
            img = codec.decode_latents(preds.reshape(-1, codec.latent_dim))
            launched = {k: _kernels.LAUNCHES[k] - before.get(k, 0)
                        for k in KERNELS}
            out[where] = (ctx.cpu(), preds.cpu(), img.cpu(), launched)
        on_kernels = path["codec"] == "vae"
        if (max(out["cpu"][3].values()) != 0
                or (min(out["gpu"][3].values()) > 0) != on_kernels):
            raise AssertionError(f"small slice launches: {out['gpu'][3]} on "
                                 f"the card, {out['cpu'][3]} on the CPU")
        ctx_err = (out["gpu"][0] - out["cpu"][0]).abs().max().item()
        lat_err = (out["gpu"][1] - out["cpu"][1]).abs().max().item()
        flips = (out["gpu"][2].int() - out["cpu"][2].int()).abs()
        flip_share = flips.float().mean().item()
        atol = SMALL_INT8_ATOL if path["int8"] else SMALL_LATENT_ATOL
        log(f"check: small f32 slice {path['name']}, card (kernels "
            f"{out['gpu'][3]}) vs CPU (plain): context max abs {ctx_err:.3e}, "
            f"preds max abs {lat_err:.3e} (bound {atol}), pixels "
            f"differing {flip_share:.4%} (bound {SMALL_PIXEL_FLIP_SHARE:.0%}),"
            f" max level difference {flips.max().item()}")
        if not (max(ctx_err, lat_err) <= atol
                and flip_share <= SMALL_PIXEL_FLIP_SHARE
                and flips.max().item() <= 1):
            raise AssertionError(f"small slice {path['name']}: the card "
                                 f"disagrees with the CPU")
    _check_rollout_variants(on_card["pixel"], frames,
                            "f32 at small width on the card",
                            SMALL_CACHED_FRAME1_REL_L2, INT8_REL_L2)


def timed_request(fn):
    """``fn()``'s result, wall seconds and the ms between CUDA events
    recorded before and after it (for a compiled request, the device time of
    its copies and replays: the host enqueues a graph in one launch)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def check_compiled(name, request, expected, eager_hook=None) -> dict:
    """A compiled request against the same request eagerly (``disable_jit``)
    on the same inputs: results equal bit for bit; a result held from
    request 1 unchanged by request 2 (on other inputs, which must give
    another result); launches by body equal eager's and ``expected``.
    ``request(i)`` runs on input set i and returns a tuple of tensors;
    ``eager_hook`` is entered around the eager request. Prints and returns
    the walls, the device ms and the idle shares."""
    with launch_window() as compiled_w:
        one, wall_c, ms_c = timed_request(lambda: request(0))
    held = [x.clone() for x in one]
    two, _, _ = timed_request(lambda: request(1))
    with J.disable_jit(), launch_window() as eager_w, (
            eager_hook or contextlib.nullcontext)():
        eager, wall_e, span_e = timed_request(lambda: request(0))
    same = [torch.equal(a, b) for a, b in zip(one, eager)]
    if not all(same):
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(one, eager)]
        raise AssertionError(f"jit: {name}: compiled differs from eager "
                             f"(equal {same}, rel L2 {rel})")
    if not all(torch.equal(a, b) for a, b in zip(held, one)):
        raise AssertionError(f"jit: {name}: request 2 overwrote the result "
                             f"held from request 1")
    if all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError(f"jit: {name}: other inputs, the same result")
    got = (compiled_w.launches, compiled_w.bodies, compiled_w.gn_bodies)
    if got != (eager_w.launches, eager_w.bodies, eager_w.gn_bodies) \
            or compiled_w.launches != expected:
        raise AssertionError(
            f"jit: {name}: launches compiled {got}, eager "
            f"{(eager_w.launches, eager_w.bodies, eager_w.gn_bodies)}, the "
            f"path implies {expected}")
    compiled_w.check(f"{name} (compiled)", expected)
    res = dict(compiled_wall_ms=wall_c * 1e3, device_ms=ms_c,
               compiled_idle=1 - ms_c / (wall_c * 1e3),
               eager_wall_ms=wall_e * 1e3, eager_span_ms=span_e,
               eager_idle=1 - ms_c / (wall_e * 1e3),
               launches=compiled_w.launches)
    log(f"jit: {name}: compiled == eager bit for bit "
        f"({len(one)} outputs); the result held from request 1 unchanged "
        f"after request 2; launches a request {compiled_w.launches} by body "
        f"{compiled_w.bodies} {compiled_w.gn_bodies}, eager's the same; "
        f"compiled wall {res['compiled_wall_ms']:.2f} ms, device "
        f"{ms_c:.2f} ms (CUDA events around the request), idle "
        f"{res['compiled_idle']:.1%}; eager wall "
        f"{res['eager_wall_ms']:.2f} ms (events span {span_e:.2f} ms), idle "
        f"{res['eager_idle']:.1%} against the compiled device ms (the same "
        f"kernels)")
    counted(compiled_w)
    return res


def jit_serving_path(models, path) -> dict:
    """Phase 4's compiled entry points of ``path`` (their graphs captured by
    its serve warm-up) against the same eagerly."""
    s = SERVED[path["name"]]
    B, rng = path["batch_clips"], np.random.default_rng(3)
    frames = [torch.from_numpy(rng.integers(
        0, 256, (B, CONTEXT, FRAME, FRAME, 3), dtype=np.uint8))
        for _ in range(2)]
    text = [None, None]
    if s["embedder"] is not None:
        text = [s["embedder"](rng.integers(0, TEXT_CLASSES, B).tolist())
                for _ in range(2)]

    def request(i):
        context, preds = s["predict"](frames[i], text[i])
        seq = torch.cat([context[:, :-1], preds], dim=1)
        return context, preds, s["decode"](seq.reshape(-1, seq.shape[-1]))

    res = check_compiled(path["name"], request,
                         expected_launches(models, path, 1))
    res["capture_s"] = sum(c["warmup_s"] + c["capture_s"]
                           for c in s["compiles"])
    return res


def jit_sd_path(models, path, sd) -> dict:
    """An SD path's compiled image (phase 5 compiled it) against the same
    eagerly, whose UNet calls a hook counts (each of batch 2)."""
    pipe, emb, img, compiles = sd
    batches = []

    @contextlib.contextmanager
    def hook():
        handle = pipe.unet.register_forward_pre_hook(
            lambda m, args: batches.append(args[0].shape[0]))
        try:
            yield
        finally:
            handle.remove()

    res = check_compiled(path["name"],
                         lambda i: (run_sd(pipe, path, emb, img, seed=i),),
                         sd_launches(models, path), eager_hook=hook)
    if batches != [2] * path["unet_calls"]:
        raise AssertionError(f"{path['name']}: {len(batches)} UNet calls of "
                             f"batches {sorted(set(batches))}; expected "
                             f"{path['unet_calls']} of batch 2")
    res["capture_s"] = sum(c["warmup_s"] + c["capture_s"]
                           for c in compiles[path["name"]])
    return res


def graph_kernel_nodes(dot_path) -> collections.Counter:
    """Kernel nodes of a ``CUDAGraph.debug_dump`` file by kernel: each node
    statement (``"graph_<g>_node_<n>"[...];``) counted once for each of the
    package's kernels its text names."""
    names = ("flash_fwd_wgmma", "flash_fwd_tf32x3", "gn_nhwc_cluster",
             "gn_nhwc_stats", "gn_nhwc_apply")
    with open(dot_path) as f:
        text = f.read()
    nodes = collections.Counter()
    for m in re.finditer(r'^"?graph_\d+_node_\d+"?\s*\[(.*?)\];\s*$', text,
                         re.M | re.S):
        nodes["all"] += 1
        for name in names:
            if name in m[1]:
                nodes[name] += 1
    return nodes


def jit_graph_dump(models, workdir) -> dict:
    """The B=8 DDIM refiner's compiled predictor captured in debug mode, its
    graph dumped and its kernel nodes counted: K1's ``flash_fwd_wgmma``
    nodes must equal the flash launches a request counts, K2's nodes (one
    ``gn_nhwc_cluster``, or a ``gn_nhwc_stats`` and a ``gn_nhwc_apply``, a
    call) the GroupNorm launches."""
    path = dict(next(p for p in PATHS if p["name"] == "vae_denoise_ar4"),
                name="vae_denoise_ar4_8streams", batch_clips=JIT_DUMP_STREAMS)
    frames = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (JIT_DUMP_STREAMS, CONTEXT, FRAME, FRAME, 3),
        dtype=np.uint8))
    J.BACKEND.debug = True
    try:
        _, predict = predict_fn(models, path)
        with launch_window() as window:
            predict(frames)
    finally:
        J.BACKEND.debug = False
    dot = os.path.join(workdir, "ddim8.dot")
    t0 = time.perf_counter()
    (graph,) = predict.impl.graphs()
    graph.debug_dump(dot)
    nodes = graph_kernel_nodes(dot)
    size = os.path.getsize(dot)
    os.unlink(dot)
    want = window.launches
    k2 = nodes["gn_nhwc_cluster"] + nodes["gn_nhwc_stats"]
    log(f"jit: {path['name']} predictor graph (debug_dump, {size / 2 ** 20:.1f}"
        f" MiB, read in {time.perf_counter() - t0:.1f} s): {nodes['all']} "
        f"nodes; K1 flash_fwd_wgmma {nodes['flash_fwd_wgmma']}, tf32x3 "
        f"{nodes['flash_fwd_tf32x3']}; K2 gn_nhwc_cluster "
        f"{nodes['gn_nhwc_cluster']}, gn_nhwc_stats {nodes['gn_nhwc_stats']}"
        f", gn_nhwc_apply {nodes['gn_nhwc_apply']}; counted launches a "
        f"request {want} by body {window.bodies} {window.gn_bodies}")
    if (nodes["flash_fwd_wgmma"] != want["flash_attention"]
            or nodes["flash_fwd_tf32x3"] or k2 != want["groupnorm_silu"]
            or nodes["gn_nhwc_apply"] != nodes["gn_nhwc_stats"]
            or not want["flash_attention"] or not want["groupnorm_silu"]):
        raise AssertionError(f"jit: the graph's kernel nodes {dict(nodes)} "
                             f"are not the counted launches {want}")
    counted(window)
    return window.launches


def phase_jit(models, sd, workdir) -> dict:
    """Every phase-4 serving path and phase-5 SD path compiled against eager
    (``check_compiled``), then the graph dump of the B=8 DDIM refiner;
    returns the compiled requests' launches. Frees phase 4's programs."""
    t0 = time.perf_counter()
    total, rows = dict.fromkeys(KERNELS, 0), {}
    for path in PATHS:
        rows[path["name"]] = jit_serving_path(models, path)
    SERVED.clear()
    for path in SD_PATHS:
        rows[path["name"]] = jit_sd_path(models, path, sd)
    for res in rows.values():
        for k in KERNELS:
            total[k] += res["launches"][k]
    torch.cuda.empty_cache()
    for k, n in jit_graph_dump(models, workdir).items():
        total[k] += n
    log("jit: table " + json.dumps({n: {k: v for k, v in r.items()
                                        if k != "launches"}
                                    for n, r in rows.items()}))
    log(f"jit: {len(rows)} paths compiled == eager; launches {total}; "
        f"{time.perf_counter() - t0:.1f} s")
    return total


def train_signatures(trainers) -> collections.Counter:
    """Every (kernel, signature) one step of each training path hands the
    dispatchers: a dry run of the step's frozen encode with the plain
    versions (the transformer reaches no kernel)."""
    t0 = time.perf_counter()
    merged = collections.Counter()
    with _kernels.force_reference():
        for path, trainer in trainers:
            with _kernels.record_calls() as rec:
                encode_or_passthrough(trainer.codec, train_frames(path), True)
            merged.update(rec.calls)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"train: dry run of the steps' encodes (plain versions) in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{ {k: sum(1 for n, _ in merged if n == k) for k in KERNELS} } "
        f"distinct signatures")
    return merged


def run_train_path(path, trainer, enc_launches) -> dict:
    """TRAIN_WARMUP + TRAIN_TIMED + 1 optimizer steps of one path through
    ``Trainer.train_loop`` on one fixed batch (the frames cross to the card
    every step, as they do from a loader); returns the window's launches."""
    name, cfg = path["name"], path["cfg"]
    batch = ([0] * cfg.batch_size, train_frames(path))
    steps = TRAIN_WARMUP + TRAIN_TIMED + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with launch_window() as window:               # the main path
        first = trainer.train_loop([batch])       # one step; fetches its loss
        for _ in range(TRAIN_WARMUP - 1):
            trainer.train_loop([batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed_m = trainer.train_loop([batch] * TRAIN_TIMED)
        torch.cuda.synchronize()                  # the one synchronise
        wall = time.perf_counter() - t0
        last = trainer.train_loop([batch])
    peak = torch.cuda.max_memory_allocated()
    if trainer.state.step != steps:
        raise AssertionError(f"{name}: {trainer.state.step} steps taken, "
                             f"expected {steps}")
    losses = (first["total_train"], timed_m["total_train"],
              last["total_train"])
    if not all(np.isfinite(v) for m in (first, timed_m, last)
               for v in m.values()):
        raise AssertionError(f"{name}: non-finite loss components: {first} "
                             f"{timed_m} {last}")
    for p in trainer.state.params.values():
        assert_finite(f"{name} parameters", p)
    n_params = sum(p.numel() for p in trainer.state.params.values())
    log(f"{name}: batch {cfg.batch_size} x {path['clip_frames']} frames of "
        f"{cfg.frame_size}px, codec {path['codec']}, precision "
        f"{path['precision']}, {n_params / 1e6:.1f}M parameters "
        f"({next(iter(trainer.state.params.values())).dtype}, Adam moments "
        f"{next(iter(trainer.state.opt_state['mu'].values())).dtype}): "
        f"{TRAIN_TIMED} timed steps in {wall:.3f} s: "
        f"{TRAIN_TIMED / wall:.3f} steps/s, "
        f"{TRAIN_TIMED * cfg.batch_size / wall:.1f} clips/s; host ms a step "
        f"mean {timed_m['step_ms_mean']:.1f} (the host waits at each batch's "
        f"copy for the step before); loss first "
        f"{losses[0]:.6f}, mean of the timed steps {losses[1]:.6f}, last "
        f"{losses[2]:.6f} ({'fell' if losses[2] < losses[0] else 'did not fall'}"
        f" in {steps} steps); components of the last step "
        f"{ {k: round(v, 6) for k, v in last.items() if k.endswith('_train')} }"
        f"; peak device memory {peak / 2 ** 30:.2f} GiB")
    if path["codec"] == "vae" and not losses[2] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall on a fixed "
                             f"batch at lr {cfg.lr}: {losses}")
    vae = path["codec"] == "vae"
    window.check(name, {k: steps * enc * vae
                        for k, enc in enc_launches.items()},
                 flash_body="tf32x3")
    return counted(window)


def dropout_cost(path, workdir):
    """What the generator-driven dropout costs a step: the path's timed
    steps again with ``dropout_p = 0`` (no draw, no mask), beside the rate
    with it."""
    rates = {}
    for p in (path["cfg"].dropout_p, 0.0):
        variant = dict(path, cfg=path["cfg"].replace(dropout_p=p))
        trainer = make_trainer(variant, workdir)
        batch = ([0] * variant["cfg"].batch_size, train_frames(variant))
        for _ in range(TRAIN_WARMUP):
            trainer.train_loop([batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_loop([batch] * TRAIN_TIMED)
        torch.cuda.synchronize()
        rates[p] = TRAIN_TIMED / (time.perf_counter() - t0)
        del trainer
        torch.cuda.empty_cache()
    with_p, without = rates[path["cfg"].dropout_p], rates[0.0]
    log(f"train: {path['name']} dropout_p {path['cfg'].dropout_p}: "
        f"{with_p:.3f} steps/s; dropout_p 0: {without:.3f} steps/s; the "
        f"dropout costs {1e3 / with_p - 1e3 / without:.2f} ms of a "
        f"{1e3 / with_p:.2f} ms step")


def check_resume(path, trainer, workdir):
    """Save the path's train state, restore it into a fresh Trainer built
    from another seed, take one step on each with the same batch and step
    number: equal losses, parameters and moments, bit for bit."""
    t0 = time.perf_counter()
    saved = trainer.save("interrupt")
    fresh = make_trainer(path, workdir, seed=1)
    fresh.resume(os.path.basename(saved))
    if fresh.state.step != trainer.state.step:
        raise AssertionError("resume: the step number was not restored")
    batch = ([0] * path["cfg"].batch_size, train_frames(path, seed=3))
    a, b = ({k: v for k, v in t.train_loop([batch]).items()
             if k.endswith("_train")} for t in (trainer, fresh))
    same = a == b
    sa, sb = trainer.state.state_dict(), fresh.state.state_dict()
    same = same and all(torch.equal(v, sb[tree][k])
                        for tree in ("params", "mu", "nu")
                        for k, v in sa[tree].items())
    size = os.path.getsize(os.path.join(saved, "state.pt"))
    log(f"train: {path['name']} state saved ({size / 2 ** 30:.2f} GiB), "
        f"restored into a fresh Trainer at step {fresh.state.step}, one step "
        f"on each: loss {a['total_train']:.6f} vs {b['total_train']:.6f}, "
        f"losses, parameters and moments "
        f"{'equal bit for bit' if same else 'DIFFER'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("resume: the restored run left the "
                             "uninterrupted one")


def check_small_train_step():
    """A small f32 VAE-codec train step (dropout off) on the card with the
    kernels against the same weights and batch on the CPU with the plain
    versions: loss components and, through Adam's first moments, the
    gradient, over 2 steps."""
    from sd_video_gen_tpu_torch.ops.losses import LossWeights
    from sd_video_gen_tpu_torch.train.trainer import make_train_step
    cfg = Config(lr=1e-3, batch_size=2, frames_per_clip=3,
                 frames_to_predict=2, frame_size=16, dropout_p=0.0)
    vae_cfg = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                        norm_num_groups=8)
    ft = FrameTransformerConfig(latent_dim=256, dim_model=64, num_heads=4,
                                num_encoder_layers=1, num_decoder_layers=2,
                                dim_feedforward=64, dropout_p=0.0,
                                frames_to_predict=2)
    frames = np.random.default_rng(4).integers(0, 256, (2, 3, 16, 16, 3),
                                               dtype=np.uint8)
    out = {}
    # one set of weights: built on the CPU, copied to the card (the two
    # devices' generators draw other numbers from the same seed)
    cpu_vae = build(AutoencoderKL, vae_cfg, "cpu", seed=0)
    cpu_model = build(FrameTransformer, ft, "cpu", seed=1, trainable=True)
    for dev in ("cpu", "cuda"):
        vae = copy.deepcopy(cpu_vae).to(dev)
        model = copy.deepcopy(cpu_model).to(dev)
        init_fn, step_fn = make_train_step(model, VAECodec(16, vae),
                                           LossWeights.from_config(cfg), cfg)
        state = init_fn()
        before = dict(_kernels.LAUNCHES)
        comps = [step_fn(state, frames, 0)[1] for _ in range(2)]
        launched = {k: _kernels.LAUNCHES[k] - before.get(k, 0)
                    for k in KERNELS}
        out[dev] = ([{k: v.item() for k, v in c.items()} for c in comps],
                    torch.cat([m.flatten().cpu()
                               for m in state.opt_state["mu"].values()]),
                    launched)
    if max(out["cpu"][2].values()) != 0 or min(out["cuda"][2].values()) == 0:
        raise AssertionError(f"small train step launches: {out['cuda'][2]} "
                             f"on the card, {out['cpu'][2]} on the CPU")
    loss_rel = max(abs(g[k] - c[k]) / abs(c[k])
                   for c, g in zip(out["cpu"][0], out["cuda"][0]) for k in c)
    grad_rel = ((out["cuda"][1] - out["cpu"][1]).norm()
                / out["cpu"][1].norm()).item()
    log(f"train: small f32 VAE-codec step, card (kernels {out['cuda'][2]}) "
        f"vs CPU (plain), 2 steps: loss components max rel {loss_rel:.3e} "
        f"(bound {SMALL_TRAIN_LOSS_RTOL}), first moments rel L2 "
        f"{grad_rel:.3e} (bound {SMALL_TRAIN_GRAD_REL_L2})")
    if not (loss_rel <= SMALL_TRAIN_LOSS_RTOL
            and grad_rel <= SMALL_TRAIN_GRAD_REL_L2):
        raise AssertionError("small train step: the card disagrees with "
                             "the CPU")


def phase_train(models, workdir) -> tuple:
    """The three training paths; returns their launches in all and
    (path, Trainer) of ``train_flagship`` (phase 9 validates it)."""
    enc_launches = {k: v[0] for k, v in passes_per_model(models).items()}
    total = {k: 0 for k in KERNELS}
    by_name = {p["name"]: p for p in TRAIN_PATHS}
    # the f32 VAE step first: its kernel shapes, each against its plain
    # version, before anything is timed
    ref = by_name["train_ref_artifact"]
    ref_trainer = make_trainer(ref, workdir)
    rows = check_signatures(train_signatures([(ref, ref_trainer)]),
                            (torch.float32,), what="train f32: ")
    # a 128px encode: one attention shape; six GroupNorm shapes with
    # SiLU and the attention block's norm without
    have = {k: sum(1 for r in rows if r["kernel"] == k
                   and r["route"] != "nchw") for k in KERNELS}
    TRAIN_F32_ROWS.extend(r for r in rows if r["kernel"] == "flash_attention")
    if (have != {"flash_attention": 1, "groupnorm_silu": 7}
            or any(r["route"] != "tf32x3" for r in TRAIN_F32_ROWS)):
        raise AssertionError(f"train: the VAE step's kernel shapes: "
                             f"{have}, bodies "
                             f"{sorted({r['route'] for r in rows})}")
    for path in TRAIN_PATHS:
        trainer = (ref_trainer if path is ref
                   else make_trainer(path, workdir))
        for k, n in run_train_path(path, trainer, enc_launches).items():
            total[k] += n
        if path["name"] == "train_flagship":
            check_resume(path, trainer, workdir)
            flagship = (path, trainer)
            dropout_cost(path, workdir)
            continue
        del trainer
        if path is ref:
            del ref_trainer
        torch.cuda.empty_cache()
    check_small_train_step()
    return total, flagship


def start_sd_weight_files(workdir) -> subprocess.Popen:
    """Write the SD VAE and UNet weight files (the port's
    ``tools/synthetic_checkpoint.py``: full-size SD-v1.4 names, fp16) in a
    process of their own, started before the first phase: numpy draws their
    943M numbers on the host for tens of seconds, while the earlier phases
    run."""
    return subprocess.Popen(
        [sys.executable, "-m", "sd_video_gen_tpu_torch.tools."
         "synthetic_checkpoint", workdir],
        cwd=os.path.dirname(os.path.abspath(__file__)))


def eval_files(models, workdir) -> dict:
    """The files the evaluation paths read, made from seeds: a
    Moving-MNIST-layout ``.npy`` (``cv2`` is not promised on the card's
    machine, so no frame tree), the config written as JSON (PyYAML is not
    promised either), the flagship transformer of phase 3 written with the
    port's checkpoint writer, the seeded I3D as a ``pytorch_i3d``-layout
    ``.pt`` and the CLIP text encoder of phase 3 in ``transformers``' layout
    (``transformers`` is not on the card's machine). The SD VAE and UNet
    files come from ``start_sd_weight_files``."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    # (T, N, 64, 64): a bright square moving across each sequence
    mnist = np.zeros((CONTEXT + 4, 5 * EVAL_CLIPS, FRAME, FRAME), np.uint8)
    for n in range(mnist.shape[1]):
        (y, x), (dy, dx) = rng.integers(4, 36, 2), rng.integers(-3, 4, 2)
        for t in range(mnist.shape[0]):
            ty, tx = y + (dy * t) % 20, x + (dx * t) % 20
            mnist[t, n, ty:ty + 16, tx:tx + 16] = rng.integers(96, 256)
    files = dict(dir=workdir, mnist=os.path.join(workdir, "mnist.npy"),
                 checkpoints=os.path.join(workdir, "checkpoints"),
                 **{k: os.path.join(workdir, f"{k}.pt")
                    for k in ("vae", "unet", "clip", "i3d")})
    np.save(files["mnist"], mnist)
    with open(os.path.join(workdir, EVAL_CONFIG + ".yml"), "w") as f:
        json.dump({"FRAMES_PER_CLIP": [CONTEXT], "FRAMES_TO_PREDICT": [4],
                   "FRAME_SIZE": FRAME, "DIM_MODEL": [FLAGSHIP["dim_model"]],
                   "NUM_HEADS": [FLAGSHIP["num_heads"]],
                   "NUM_ENCODER_LAYERS": [FLAGSHIP["num_encoder_layers"]],
                   "NUM_DECODER_LAYERS": [FLAGSHIP["num_decoder_layers"]],
                   "DROPOUT_P": [0.0]}, f)
    ft = models["ar"]
    state = TrainState(ft, Adam(1e-5).init(dict(ft.named_parameters())))
    save_checkpoint(checkpoint_path(files["checkpoints"], EVAL_CONFIG, 0,
                                    "test"), state.state_dict())
    sd = {"text_model." + k: v for k, v in models["clip"].state_dict().items()}
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(sd, files["clip"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "no I3D weights": seeded here
        torch.save(load_i3d(None, "cpu").state_dict(), files["i3d"])
    log(f"eval: files written in {time.perf_counter() - t0:.1f} s: "
        f"{mnist.shape} Moving-MNIST .npy, the flagship checkpoint "
        f"({sum(p.numel() for p in ft.parameters()) / 1e6:.1f}M parameters, "
        f"{ft.out.weight.dtype}), CLIP and I3D .pt")
    return files


def eval_argv(files, path, clips=EVAL_CLIPS, weights=True) -> list:
    """The command line of an evaluation path; ``weights=False`` leaves the
    SD modules seeded (the dry run: the same shapes)."""
    argv = ["--dataset", "mnist", "--folder", files["mnist"], "--config",
            EVAL_CONFIG, "--config_dir", files["dir"], "--checkpoint_dir",
            files["checkpoints"], "--codec", "vae", "--denoise", "True",
            "--pred_frames", str(path["pred"]), "--batch_clips",
            str(path["batch_clips"]), "--max_clips", str(clips), "--timing"]
    if weights:
        for k in ("vae", "unet", "clip"):
            argv += [f"--{k}_weights", files[k]]
    if path["name"] == "fvd_native_ar4":
        return argv + ["--i3d_weights", files["i3d"], "--fvd_api",
                       "streaming"]
    return argv + ["--rollout", path["rollout"]]


def run_cli(path, argv):
    """The path's entry point in this process: (its return value, the lines
    it printed)."""
    main = predict_fvd.main if path["name"] == "fvd_native_ar4" else P.main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines()


def eval_signatures(files) -> dict:
    """Every (kernel, signature) one batch of each evaluation path hands the
    dispatchers: a dry run with the plain versions, by path name."""
    by_path = {}
    with _kernels.force_reference():
        for path in EVAL_PATHS:
            with _kernels.record_calls() as rec:
                run_cli(path, eval_argv(files, path, path["batch_clips"],
                                        weights=False))
            by_path[path["name"]] = rec.calls
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    merged = merge_signatures(by_path.values())
    log(f"kernel: dry run of the {len(by_path)} evaluation paths (plain "
        f"versions, one batch each): "
        f"{ {k: sum(1 for n, _ in merged if n == k) for k in KERNELS} } "
        f"distinct signatures")
    return by_path


def run_eval_path(models, files, path) -> dict:
    """One evaluation path at full width: finite results, exact launches by
    body, its rates from its own ``--timing`` line."""
    name, batches = path["name"], EVAL_CLIPS // path["batch_clips"]
    t0 = time.perf_counter()
    with launch_window() as window:               # the main path
        out, lines = run_cli(path, eval_argv(files, path))
    wall = time.perf_counter() - t0
    for line in lines[:-1]:
        log(f"{name}: | {line}")
    timing = json.loads(lines[-1])
    if name == "fvd_native_ar4":
        fvd, mse = out
        if not (np.isfinite(fvd) and np.isfinite(mse)):
            raise AssertionError(f"{name}: FVD {fvd}, MSE {mse}")
        walls = timing["batches"]
        if [w["clips"] for w in walls] != [path["batch_clips"]] * batches:
            raise AssertionError(f"{name}: batches {walls}")
        warm = walls[1]
        log(f"{name}: FVD {fvd:.6f}, pred MSE {mse:.6f} over {EVAL_CLIPS} "
            f"clips; warm batch (the second): {warm['clips']} clips in "
            f"{warm['gen_s'] + warm['i3d_s']:.4f} s = "
            f"{warm['clips'] / (warm['gen_s'] + warm['i3d_s']):.3f} clips/s "
            f"(rollout, refine and decode {warm['gen_s'] * 1e3:.1f} ms; I3D "
            f"of {warm['clips']} real + {warm['clips']} generated clips at "
            f"224px in f32 {warm['i3d_s'] * 1e3:.1f} ms); first batch "
            f"{walls[0]['gen_s'] + walls[0]['i3d_s']:.3f} s; the call "
            f"{wall:.1f} s (building and loading included)")
    else:
        if f"predicted {path['pred']} frames for {EVAL_CLIPS} clips" \
                not in lines:
            raise AssertionError(f"{name}: {lines}")
        if (timing["clips"], timing["batches"]) != (EVAL_CLIPS, batches):
            raise AssertionError(f"{name}: timing {timing}")
        warm = ((EVAL_CLIPS - path["batch_clips"]) * path["pred"]
                / (timing["total_s"] - timing["first_sync_s"]))
        log(f"{name}: timing {json.dumps(timing)}; warm predicted frames/s "
            f"after the first batch: {warm:.3f}; the call {wall:.1f} s "
            f"(building and loading included)")
    window.check(name, expected_launches(models, path, batches))
    return counted(window)


def check_trainer_fvd(path, trainer, i3d):
    """``Trainer.fvd_validation`` of a training path, both protocols, over
    two seeded batches: finite FVD, wall time."""
    loader = [([0] * path["cfg"].batch_size, train_frames(path, seed=s))
              for s in (5, 6)]
    for protocol in ("last_k", "reference"):
        torch.cuda.synchronize()
        with launch_window() as window:
            t0 = time.perf_counter()
            fvd = trainer.fvd_validation(loader, i3d, max_batches=2,
                                         protocol=protocol)
            ms = (time.perf_counter() - t0) * 1e3
        log(f"{path['name']}_fvd: fvd_validation protocol {protocol}, 2 "
            f"batches of {path['cfg'].batch_size} clips x "
            f"{path['clip_frames']} frames of {path['cfg'].frame_size}px: FVD "
            f"{fvd:.6f}, {ms:.1f} ms")
        if not np.isfinite(fvd):
            raise AssertionError(f"fvd_validation {protocol}: FVD {fvd}")
        window.check(f"{path['name']}_fvd", {k: 0 for k in KERNELS})


def check_i3d(i3d_path):
    """I3D on the card against the CPU: the same weights and batch."""
    x = np.random.default_rng(12).uniform(-1, 1, I3D_SHAPE).astype(np.float32)
    x = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    out = {}
    for dev in ("cpu", "cuda"):
        with torch.inference_mode():
            out[dev] = load_i3d(i3d_path, dev)(x.to(dev)).cpu()
    assert_finite("I3D logits", out["cuda"])
    rel = ((out["cuda"] - out["cpu"]).norm() / out["cpu"].norm()).item()
    log(f"eval: I3D {I3D_SHAPE} f32 logits, card vs CPU: rel L2 {rel:.3e} "
        f"(bound {I3D_REL_L2})")
    if not rel <= I3D_REL_L2:
        raise AssertionError("I3D: the card disagrees with the CPU")


def check_sd_files(files) -> None:
    """The file constructors on the full-size weight files the evaluation
    paths read: ``SDPipeline.from_pretrained_dir`` on a diffusers directory
    of links to them, ``VAECodec.from_checkpoint`` on the VAE file. Their
    parameters must equal, bit for bit, the modules the predict CLI builds
    from the same files (``predict.sd_modules``); the codec's posterior
    sample with zero noise is its mean, a draw from a generator is finite
    and another; the VAE's sampled forward is finite."""
    t0 = time.perf_counter()
    root = os.path.join(files["dir"], "diffusers")
    for sub, name, key in (("vae", "diffusion_pytorch_model.bin", "vae"),
                           ("unet", "diffusion_pytorch_model.bin", "unet"),
                           ("text_encoder", "pytorch_model.bin", "clip")):
        os.makedirs(os.path.join(root, sub))
        os.symlink(files[key], os.path.join(root, sub, name))
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    pipe = SDPipeline.from_pretrained_dir(root, dev, bf16)
    cli = P.sd_modules(argparse.Namespace(
        **{f"{k}_weights": files[k] for k in ("vae", "unet", "clip")}),
        dev, bf16)
    for mine, theirs in zip((pipe.vae, pipe.unet, pipe.clip), cli):
        want = theirs.state_dict()
        if not all(torch.equal(v, want[k])
                   for k, v in mine.state_dict().items()):
            raise AssertionError(f"from_pretrained_dir: {type(mine).__name__}"
                                 f" differs from the file's")
    del cli
    codec = VAECodec.from_checkpoint(FRAME, files["vae"], dev, bf16)
    if not all(torch.equal(v, pipe.vae.state_dict()[k])
               for k, v in codec.model.state_dict().items()):
        raise AssertionError("VAECodec.from_checkpoint: weights differ")
    frames = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (2, CONTEXT, FRAME, FRAME, 3), dtype=np.uint8))
    n, h = 2 * CONTEXT, codec.latent_hw
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        mean = codec.encode_frames(frames)
        zero = codec.encode_frames(frames, noise=torch.zeros(
            n, codec.latent_channels, h, h, device=dev))
        drawn = assert_finite("posterior sample",
                              codec.encode_frames(frames, generator=g))
        x = frames[:1, 0].to(dev).permute(0, 3, 1, 2).float() / 127.5 - 1
        dec, _, _ = pipe.vae(x, generator=g, sample=True)
        assert_finite("sampled VAE forward", dec)
    if not torch.equal(zero, mean) or torch.equal(drawn, mean):
        raise AssertionError("VAECodec: the posterior sample is not "
                             "mean + std * noise")
    log(f"eval: SDPipeline.from_pretrained_dir (diffusers layout) and "
        f"VAECodec.from_checkpoint on the full-size files: parameters equal "
        f"the predict CLI's bit for bit; posterior sample with zero noise == "
        f"mean, a generator's draw finite and another (mean |draw - mean| "
        f"{(drawn - mean).abs().mean().item():.4f}); sampled VAE forward "
        f"{tuple(dec.shape)} finite; {time.perf_counter() - t0:.1f} s")
    del pipe, codec
    torch.cuda.empty_cache()


def phase_eval(models, files, sd_files, flagship) -> dict:
    """The two evaluation paths, ``fvd_validation`` on the ``train_flagship``
    Trainer and I3D card vs CPU; returns the paths' launches."""
    t0 = time.perf_counter()
    if sd_files.wait(timeout=600) != 0:
        raise RuntimeError(f"the SD weight files were not written: exit "
                           f"{sd_files.returncode}")
    log(f"eval: SD weight files ready after {time.perf_counter() - t0:.1f} s "
        f"more: " + ", ".join(f"{k}.pt {os.path.getsize(files[k]) / 2 ** 30:.2f}"
                              f" GiB" for k in ("vae", "unet")))
    total = {k: 0 for k in KERNELS}
    for path in EVAL_PATHS:
        for k, n in run_eval_path(models, files, path).items():
            total[k] += n
        torch.cuda.empty_cache()
    check_trainer_fvd(*flagship, load_i3d(files["i3d"], "cuda"))
    check_i3d(files["i3d"])
    check_sd_files(files)
    log(f"eval: {time.perf_counter() - t0:.1f} s")
    return total


def data_files(workdir) -> dict:
    """The data phase's config (JSON: PyYAML is not promised here) and its
    frames: a Moving-MNIST-layout (T, N, 128, 128) .npy, a bright square
    moving across each sequence."""
    rng = np.random.default_rng(13)
    size = TRAIN_FRAME
    mnist = np.zeros((DATA_FRAMES, DATA_SEQS, size, size), np.uint8)
    for n in range(DATA_SEQS):
        (y, x), (dy, dx) = rng.integers(8, 72, 2), rng.integers(-6, 7, 2)
        for t in range(DATA_FRAMES):
            ty, tx = y + (dy * t) % 40, x + (dx * t) % 40
            mnist[t, n, ty:ty + 32, tx:tx + 32] = rng.integers(96, 256)
    files = dict(dir=workdir, mnist=os.path.join(workdir, "mnist128.npy"),
                 cache=os.path.join(workdir, "frame_cache"),
                 text_cache=os.path.join(workdir, "text_cache"),
                 checkpoints=os.path.join(workdir, "checkpoints"))
    np.save(files["mnist"], mnist)
    write_config(os.path.join(workdir, DATA_CONFIG + ".yml"), DATA_YML)
    return files


def build_caches(files) -> dict:
    """The train and test frame caches through the cache CLI; each .bin
    held byte for byte against its dataset's clips. Returns clips by
    stage."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        native_loader.main(["--dataset", "mnist", "--folder", files["mnist"],
                            "--config", DATA_CONFIG, "--config_dir",
                            files["dir"], "--out", files["cache"]])
    wall = time.perf_counter() - t0
    clips = {}
    for stage in ("train", "test"):
        ds = MovingMNISTDataset(DATA_FRAMES, 1, files["mnist"], stage, seed=0)
        want = np.stack([ds[i][1] for i in range(len(ds))])
        got = np.fromfile(os.path.join(files["cache"], f"{stage}.bin"),
                          np.uint8)
        if not np.array_equal(got, want.reshape(-1)):
            raise AssertionError(f"data: the {stage} cache's bytes are not "
                                 f"the dataset's clips")
        clips[stage] = len(ds)
    n = sum(clips.values())
    log(f"data: cache CLI wrote {clips} clips of {list(want.shape[1:])} "
        f"uint8 ({n * want[0].nbytes / 2 ** 20:.1f} MiB) in {wall:.3f} s: "
        f"{n / wall:.1f} clips/s; bytes equal to the dataset's clips "
        f"({out.getvalue().strip().splitlines()})")
    return clips


def data_signatures(enc_vae) -> list:
    """The data path's encode (6 clips x 10 frames at 128px, the f32 VAE)
    with the plain versions records its kernel shapes; each is held against
    its plain version in f32."""
    frames = np.zeros((6, DATA_FRAMES, TRAIN_FRAME, TRAIN_FRAME, 3), np.uint8)
    with _kernels.force_reference(), _kernels.record_calls() as rec:
        encode_or_passthrough(VAECodec(TRAIN_FRAME, enc_vae), frames, True)
    torch.cuda.synchronize()
    return check_signatures(rec.calls, (torch.float32,), what="data f32: ")


@contextlib.contextmanager
def timed_train_loops():
    """Times of every ``Trainer.train_loop`` run while open: (seconds,
    steps, warm seconds). The seconds run from a synchronised device to the
    loop's own loss fetch (which waits for its last step); the warm seconds
    from the first step's end (the device synchronised there once) to the
    same fetch."""
    walls, real = [], Trainer.train_loop

    def timed(self, loader, seed=0):
        step_fn, first = self._step_fn, []

        def step(*args):
            out = step_fn(*args)
            if not first:
                torch.cuda.synchronize()
                first.append(time.perf_counter())
            return out
        self._step_fn = step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = real(self, loader, seed)
        finally:
            self._step_fn = step_fn
        t1 = time.perf_counter()
        walls.append((t1 - t0, out.get("steps_timed", 0), t1 - first[0]))
        return out
    Trainer.train_loop = timed
    try:
        yield walls
    finally:
        Trainer.train_loop = real


def run_native_path(files, name, extra=()) -> tuple:
    """``train/trainer.main`` from the native cache; returns (the epoch's
    metrics, the launch window, train steps, batches served, the checkpoint's
    path)."""
    argv = ["--dataset", "mnist", "--config", DATA_CONFIG, "--config_dir",
            files["dir"], "--native_cache", files["cache"], "--codec", "vae",
            "--precision", "bf16_full", "--checkpoint_dir",
            files["checkpoints"], "--debug", "True", *extra]
    native_loader.NEXT_BATCH.clear()
    multihost.COLLECTIVES.clear()
    before = set(os.listdir(files["checkpoints"])) \
        if os.path.isdir(files["checkpoints"]) else set()
    with timed_train_loops() as walls, launch_window() as window, \
            contextlib.redirect_stdout(io.StringIO()):   # the main path
        (history,) = T.main(argv)
    gc.collect()
    torch.cuda.empty_cache()
    (ckpt,) = set(os.listdir(files["checkpoints"])) - before
    (m,) = history
    (wall, steps, warm), = walls
    waited = native_loader.NEXT_BATCH
    if not all(np.isfinite(v) for v in m.values()
               if isinstance(v, float)):
        raise AssertionError(f"{name}: non-finite metrics {m}")
    log(f"{name}: one epoch, {steps} steps of 6 clips x {DATA_FRAMES} frames "
        f"of {TRAIN_FRAME}px in {wall:.3f} s, the first step included; "
        f"the {steps - 1} warm steps in {warm:.3f} s: "
        f"{(steps - 1) / warm:.3f} steps/s, {6 * (steps - 1) / warm:.1f} "
        f"clips/s; host ms a step mean {m['step_ms_mean']:.1f} (the host "
        f"waits at each batch's copy for the step before); "
        f"host blocked in fl_next_batch {waited['seconds'] * 1e3:.2f} ms over "
        f"{waited['batches']} batches (train and val), "
        f"{waited['seconds'] * 1e3 / max(waited['batches'], 1):.3f} ms a "
        f"batch; train loss {m['train_loss']:.6f}, val loss "
        f"{m['val_loss']:.6f}; checkpoint {ckpt}; collectives "
        f"{dict(multihost.COLLECTIVES)}")
    return m, window, steps, waited["batches"], \
        os.path.join(files["checkpoints"], ckpt)


def _same_state(path_a, path_b) -> bool:
    a, b = (torch.load(os.path.join(p, "state.pt"), map_location="cpu",
                       mmap=True, weights_only=True) for p in (path_a, path_b))
    return a["step"] == b["step"] and all(
        torch.equal(v, b[tree][k]) for tree in ("params", "mu", "nu")
        for k, v in a[tree].items())


class LabelledClips:
    """A seeded dataset of TEXT_CLASSES classes: n clips of 10 128px
    frames, clip i of class drawn from the seed."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, TEXT_CLASSES, n).tolist()
        self.clips = rng.integers(0, 256, (n, DATA_FRAMES, TRAIN_FRAME,
                                           TRAIN_FRAME, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return [self.labels[i]] * DATA_FRAMES, self.clips[i]


def run_text_path(files):
    """A few ``--train_mode text`` steps from a labelled cache through
    ``_LabelMappedLoader``: the embedder must get the header's class of
    every clip the loader served."""
    for stage, n, seed in (("train", DATA_TEXT_CLIPS[0], 21),
                           ("test", DATA_TEXT_CLIPS[1], 22)):
        native_loader.build_frame_cache(LabelledClips(n, seed),
                                        files["text_cache"], stage)
    served, embedded = [], []
    real_iter, real_call = (native_loader.NativeBatchLoader.__iter__,
                            ClassNameEmbedder.__call__)

    def spy_iter(self):
        for ids, frames in real_iter(self):
            served.append([self.labels[i] for i in ids])
            yield ids, frames

    def spy_call(self, labels):
        embedded.append(np.asarray(labels).tolist())
        return real_call(self, labels)
    native_loader.NativeBatchLoader.__iter__ = spy_iter
    ClassNameEmbedder.__call__ = spy_call
    try:
        with launch_window() as window, \
                contextlib.redirect_stdout(io.StringIO()):
            (history,) = T.main([
                "--dataset", "mnist", "--config", DATA_CONFIG, "--config_dir",
                files["dir"], "--native_cache", files["text_cache"],
                "--train_mode", "text", "--codec", "pixel", "--precision",
                "bf16_full", "--checkpoint_dir", files["checkpoints"],
                "--debug", "True"])
    finally:
        native_loader.NativeBatchLoader.__iter__ = real_iter
        ClassNameEmbedder.__call__ = real_call
    gc.collect()
    torch.cuda.empty_cache()
    (m,) = history
    if served != embedded or not served:
        raise AssertionError(f"text: the embedder got {embedded}, the cache "
                             f"served {served}")
    if not (np.isfinite(m["train_loss"]) and np.isfinite(m["val_loss"])):
        raise AssertionError(f"text: non-finite losses {m}")
    window.check("train_native_text", {k: 0 for k in KERNELS})
    log(f"train_native_text: {len(served)} batches (train and val) through "
        f"_LabelMappedLoader; the embedder got the header's class of every "
        f"served clip; train loss {m['train_loss']:.6f}, val loss "
        f"{m['val_loss']:.6f}")


def phase_data(workdir) -> dict:
    """The cache CLI, ``train_native_ucf_vae`` plain and under a one-process
    NCCL group, and the text-mode path; returns the main path's
    launches (the plain run's)."""
    t0 = time.perf_counter()
    files = data_files(workdir)
    clips = build_caches(files)
    train_b, val_b = clips["train"] // 6, clips["test"] // 6
    vae = build(AutoencoderKL, VAEConfig(), "cuda")   # the trainer's codec
    enc = {"flash_attention": sum(isinstance(x, AttnBlock)
                                  for x in vae.encoder.modules()),
           "groupnorm_silu": sum(isinstance(x, nn.GroupNorm)
                                 for x in vae.encoder.modules())}
    rows = data_signatures(vae)
    del vae
    torch.cuda.empty_cache()
    expected = {k: (train_b + val_b) * n for k, n in enc.items()}
    log(f"data: {len(rows)} kernel rows at the path's shapes agree in f32; "
        f"expected launches {expected} = ({train_b} train + {val_b} val "
        f"batches) x {enc} an encode")
    name = "train_native_ucf_vae"
    plain, window, steps, batches, ckpt_a = run_native_path(files, name)
    window.check(name, expected, flash_body="tf32x3")
    if (steps, batches) != (train_b, train_b + val_b):
        raise AssertionError(f"{name}: {steps} steps, {batches} batches")
    with socket.socket() as s:          # a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host, no network
    try:
        group, window2, _, _, ckpt_b = run_native_path(
            files, name + "_multihost",
            ("--multihost", "--num_processes", "1", "--process_id", "0",
             "--coordinator", f"127.0.0.1:{port}"))
        reduced = dict(multihost.COLLECTIVES)
        backend = torch.distributed.get_backend()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    window2.check(name + "_multihost", expected, flash_body="tf32x3")
    losses = lambda m: {k: v for k, v in m.items() if k.endswith(("_train",
                                                                  "_val"))}
    same = losses(plain) == losses(group) and _same_state(ckpt_a, ckpt_b)
    log(f"{name}_multihost: {backend} group of 1: losses, parameters and "
        f"moments {'equal bit for bit' if same else 'DIFFER'} to the plain "
        f"run's; gradient all-reduces {reduced.get('grads', 0)} for {steps} "
        f"steps")
    if not same or backend != "nccl" or reduced.get("grads") != steps:
        raise AssertionError(f"{name}_multihost: same {same}, backend "
                             f"{backend}, collectives {reduced}")
    run_text_path(files)
    log(f"data: {time.perf_counter() - t0:.1f} s")
    return counted(window)


# The tp phase (phase 11): the three multi-process entry points as four
# worker processes on the one card (this script again, ``--tp-worker``),
# joined in a gloo group (NCCL refuses two ranks on one device; gloo stages
# its collectives of CUDA tensors through host memory, the port's ring
# exchange does so itself), each held against the same entry point in this
# process. ``predict`` is ``predict_cli_denoise_ar4`` cut to 1 predicted
# frame: 8 clips (the VAE mid block's batch of 8 splits over the 4 ranks)
# and 3 clips (3 does not divide by 4: the 512px mid block takes the ring,
# 4096 / 4 = 1024 tokens a rank); ``fvd`` is ``fvd_native_ar4`` over the
# data axis; ``train`` is ``train_flagship``'s model at published widths
# from the data phase's frame cache, f32, 3 steps, dropout 0 and again 0.1.
TP_WORLD, TP_BACKEND = 4, "backend gloo (one card, host-staged)"
TP_TIMEOUT = 420                           # seconds, a set of four workers
TP_RUNS = [
    dict(name="tp_predict_denoise_4", entry="predict",
         mesh="data=1,model=4", clips=4, route="batch"),
    dict(name="tp_predict_denoise_3", entry="predict",
         mesh="data=1,model=4", clips=3, route="ring"),
    dict(name="tp_fvd_native", entry="fvd", mesh="data=4"),
    dict(name="tp_train_flagship", entry="train", mesh="data=2,model=2",
         config="tp_flagship"),
    dict(name="tp_train_flagship_dropout", entry="train",
         mesh="data=2,model=2", config="tp_flagship_dropout")]
# Bounds against the one-process run of the same entry point on the card.
# predict (bf16): each split layer's output is the sum of bf16 partial
# products, rounded once more per rank, so the run's bf16 rounding differs
# from one process's from the first split layer on and the refiner's uint8
# round trips carry it on (the one-process run's own bf16 distance from f32
# is the scale: phase 6's floors are 1-4e-2 a pass). Held against the same
# entry point in f32 in one process: the tensor-parallel bf16 run no
# farther from it than TP_PREDICT_OVER_BF16 times the one-process bf16
# run (predicted latents and decoded frames, relative L2).
TP_PREDICT_OVER_BF16 = 2.0
# fvd (data=4): I3D in f32 on 2 clips a rank instead of 8: the real clips'
# statistics differ in summation order only; the generated clips come
# from the bf16 refiner at another batch size (cuBLAS and cuDNN may pick
# other algorithms), so FVD and MSE move with it.
TP_REAL_STATS_RTOL = 1e-5
TP_FVD_RTOL, TP_MSE_RTOL = 5e-2, 2e-2
# train (f32, TF32 off, 3 Adam steps): every step's loss components
# relative; the moments after the first step relative L2 per tensor
# (summation order only); after the last, every parameter within 2 lr a
# step (Adam's first steps move each element by about lr, so where a
# gradient is rounding noise the two runs step apart by up to 2 lr) and the
# moments within TP_LAST_MOMENT_REL_L2 (the later gradients are taken at
# those parted parameters).
TP_LOSS_RTOL, TP_MOMENT_REL_L2, TP_LAST_MOMENT_REL_L2 = 1e-4, 1e-4, 5e-2


def tp_argv(run, files, data_dir) -> list:
    """The entry point's command line; the mesh comes on top."""
    if run["entry"] == "predict":
        path = dict(EVAL_PATHS[1], pred=1)
        return eval_argv(files, path, clips=run["clips"])
    if run["entry"] == "fvd":
        return eval_argv(files, EVAL_PATHS[0])
    return ["--dataset", "mnist", "--config", run["config"], "--config_dir",
            data_dir, "--native_cache", os.path.join(data_dir, "frame_cache"),
            "--codec", "pixel", "--precision", "f32", "--checkpoint_dir",
            os.path.join(os.getcwd(), "checkpoints"), "--debug", "True"]


def tp_entry(run, argv):
    """Drive ``run``'s entry point in this process with spies on what it
    computes: (its return value, what the spies saw). Eager
    (``disable_jit``), as every rank of a sharded run is: the spies copy
    what they see to the host between the ops, which a capture cannot
    hold."""
    from sd_video_gen_tpu_torch.evaluation import predict_fvd as PPF
    seen = collections.defaultdict(list)
    real = (P.make_predict_fn, P.build_codec, PPF.make_sharded_features,
            Trainer.fit)

    def make(*a, **kw):
        fn = real[0](*a, **kw)

        def run_(*b, **kwb):
            out = fn(*b, **kwb)
            seen["latents"].append(out[1].float().cpu())
            return out
        return run_

    def codec(*a, **kw):
        c = real[1](*a, **kw)
        decode = c.decode_latents

        def dec(x):
            out = decode(x)
            seen["frames"].append(out.cpu())
            return out
        c.decode_latents = dec
        return c

    def stats(i3d, layout):
        fn = real[2](i3d, layout)

        def run_(v):
            st = fn(v)
            seen["stats"].append((st.n, st.raw_sum, st.raw_prod))
            return st
        return run_

    def fit(self, *a, **kw):
        seen["trainer"].append(self)
        if self.state is None:            # as fit itself would
            self.init_state(seed=kw.get("seed", 0))
        step_fn = self._step_fn

        def step(*b):
            state, comps = step_fn(*b)
            seen["steps"].append({k: float(v) for k, v in comps.items()})
            if len(seen["steps"]) == 1:     # every rank gathers, one keeps
                full = self.full_state()
                if multihost.is_coordinator():
                    seen["first"] = {t: {k: v.cpu() for k, v in
                                         full[t].items()}
                                     for t in ("mu", "nu")}
            return state, comps
        self._step_fn = step
        return real[3](self, *a, **kw)
    P.make_predict_fn, P.build_codec = make, codec
    PPF.make_sharded_features, Trainer.fit = stats, fit
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                J.disable_jit():
            main = {"predict": P.main, "fvd": PPF.main,
                    "train": T.main}[run["entry"]]
            ret = main(argv)
    finally:
        P.make_predict_fn, P.build_codec = real[:2]
        PPF.make_sharded_features, Trainer.fit = real[2:]
    seen["lines"] = out.getvalue().splitlines()
    return ret, seen


def _digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _train_result(ret, seen) -> dict:
    """What a training run leaves to compare: the history, the saved
    (gathered) checkpoint's path, digests of this rank's own parameters."""
    (trainer,) = seen.pop("trainer")
    return dict(history=ret, steps=seen["steps"], first=seen.get("first"),
                checkpoint=checkpoint_path(
                    trainer.checkpoint_dir, trainer.cfg.config_name,
                    trainer.index, "test"),
                digests={k: (_digest(p), trainer.placements[k] is not None)
                         for k, p in trainer.state.params.items()})


def tp_worker(rank: str, world: str, port: str, job: str, out: str) -> int:
    """One rank of a tp run: joins the gloo group on this card (LOCAL_RANK
    is 0 in every worker), drives the entry point under the mesh with the
    counts at 0, and saves what it saw, its launches and the kernel
    signatures it handed the dispatchers."""
    from sd_video_gen_tpu_torch.ops.attention import TP_ROUTES
    strict_f32()
    with open(job) as f:
        run, argv = json.load(f)
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                         device="cuda", backend="gloo")
    if multihost.rank_device(torch.device("cuda")) != torch.device("cuda", 0):
        raise AssertionError("a worker left the one card")
    argv = argv + ["--mesh", run["mesh"]]
    TP_ROUTES.clear()
    t0 = time.perf_counter()
    with launch_window() as window, _kernels.record_calls() as rec:
        ret, seen = tp_entry(run, argv)
    res = dict(seconds=time.perf_counter() - t0, launches=window.launches,
               bodies=window.bodies, gn_bodies=window.gn_bodies,
               routes=dict(TP_ROUTES), sigs=dict(rec.calls),
               backend=torch.distributed.get_backend(), lines=seen["lines"])
    if run["entry"] == "train":
        res.update(_train_result(ret, seen))
    else:
        res.update(ret=ret, **{k: v for k, v in seen.items()
                               if k != "lines"})
    torch.save(res, out)
    torch.distributed.destroy_process_group()
    return 0


def run_tp_workers(run, argv, workdir) -> list:
    """``run`` as TP_WORLD worker processes on the one card; their results
    by rank. A worker that fails or outlives TP_TIMEOUT ends the phase,
    every worker stopped."""
    job = os.path.join(workdir, f"{run['name']}.json")
    with open(job, "w") as f:
        json.dump([run, argv], f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, LOCAL_RANK="0")
    outs = [os.path.join(workdir, f"{run['name']}_rank{r}.pt")
            for r in range(TP_WORLD)]
    logs = [open(os.path.join(workdir, f"{run['name']}_rank{r}.log"), "w")
            for r in range(TP_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         str(TP_WORLD), str(port), job, outs[r]], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=workdir) for r in range(TP_WORLD)]
    end = time.monotonic() + TP_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(logs[bad[0]].name) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"{run['name']}: workers {bad} failed "
                             f"({[p.returncode for p in procs]}); rank "
                             f"{bad[0]}:\n{tail}")
    return [torch.load(o, weights_only=False) for o in outs]


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).norm() / b.norm())


def check_tp_predict(run, ranks, one, one32, expected) -> None:
    """Every rank's latents and frames against the one-process runs' in
    bf16 and f32; launches per rank exact (the ring's calls run no kernel),
    the route."""
    cat = lambda res, k: torch.cat(res[k]).float()
    floor = {k: _rel(cat(one, k), cat(one32, k)) for k in ("latents",
                                                           "frames")}
    for r, res in enumerate(ranks):
        got = {k: _rel(cat(res, k), cat(one32, k)) for k in floor}
        same = {k: _rel(cat(res, k), cat(one, k)) for k in floor}
        log(f"{run['name']}: rank {r}, rel L2 against one process in f32 "
            f"(one process in bf16 / this rank): predicted latents "
            f"{floor['latents']:.3e} / {got['latents']:.3e}, decoded frames "
            f"{floor['frames']:.3e} / {got['frames']:.3e} (bound "
            f"{TP_PREDICT_OVER_BF16}x the first); against one process in "
            f"bf16: {same['latents']:.3e}, {same['frames']:.3e}; routes "
            f"{res['routes']}")
        if not all(got[k] <= TP_PREDICT_OVER_BF16 * floor[k] for k in got):
            raise AssertionError(f"{run['name']}: rank {r} disagrees")
        if res["routes"].get(run["route"], 0) == 0:
            raise AssertionError(f"{run['name']}: the {run['route']} route "
                                 f"did not run: {res['routes']}")
        want = dict(expected,
                    flash_attention=expected["flash_attention"]
                    - res["routes"].get("ring", 0))
        _check_worker_launches(run, r, res, want)


def _check_worker_launches(run, r, res, want, flash_body="wgmma"):
    launches = res["launches"]
    if (launches != want
            or res["gn_bodies"].get("nhwc", 0) != launches["groupnorm_silu"]
            or res["bodies"].get(flash_body, 0)
            != launches["flash_attention"]):
        raise AssertionError(f"{run['name']}: rank {r} launches {launches} "
                             f"(bodies {res['bodies']} {res['gn_bodies']}), "
                             f"the path implies {want}")


def check_tp_fvd(run, ranks, one, expected) -> None:
    fvd1, mse1 = one["ret"]
    real_one = one["stats"][0::2]
    for r, res in enumerate(ranks):
        fvd, mse = res["ret"]
        real = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                / np.maximum(np.abs(np.asarray(b)), 1e-30)))
                   for st, st1 in zip(res["stats"][0::2], real_one)
                   for a, b in zip(st, st1))
        log(f"{run['name']}: rank {r}: FVD {fvd:.6f} vs {fvd1:.6f} (rtol "
            f"{TP_FVD_RTOL}), MSE {mse:.6f} vs {mse1:.6f} (rtol "
            f"{TP_MSE_RTOL}), real clips' FeatureStats max rel diff "
            f"{real:.3e} (rtol {TP_REAL_STATS_RTOL}), summed over the data "
            f"axis")
        if not (abs(fvd - fvd1) <= TP_FVD_RTOL * abs(fvd1)
                and abs(mse - mse1) <= TP_MSE_RTOL * abs(mse1)
                and real <= TP_REAL_STATS_RTOL
                and len(res["stats"]) == len(one["stats"])):
            raise AssertionError(f"{run['name']}: rank {r} disagrees")
        _check_worker_launches(run, r, res, expected)


def _states(path_a, path_b):
    return (torch.load(os.path.join(p, "state.pt"), map_location="cpu",
                       mmap=True, weights_only=True) for p in (path_a, path_b))


def check_tp_train(run, ranks, one, lr: float) -> None:
    """Losses and the gathered state against one process (dropout 0), or
    the replicated parameters bit-equal across the model ranks (dropout
    on)."""
    digests = [res["digests"] for res in ranks]
    whole = [k for k, (_, split) in digests[0].items() if not split]
    same = all(d[k][0] == digests[0][k][0] for d in digests for k in whole)
    split = [k for k, (_, s) in digests[0].items() if s]
    log(f"{run['name']}: {len(whole)} replicated parameters "
        f"{'bit-equal' if same else 'DIFFER'} on all {TP_WORLD} ranks, "
        f"{len(split)} split over the model axis")
    if not same or not split:
        raise AssertionError(f"{run['name']}: replicated parameters drift")
    for res in ranks:
        _check_worker_launches(run, 0, res, {k: 0 for k in KERNELS})
    if one is None:
        return
    # a step's components are each data rank's own (its rows' means):
    # their mean is the global batch's (equal rows), one per model group
    model = int(dict(a.split("=") for a in run["mesh"].split(","))["model"])
    by_data = [res["steps"] for res in ranks[::model]]
    got = [{k: sum(d[i][k] for d in by_data) / len(by_data) for k in w}
           for i, w in enumerate(one["steps"][:len(by_data[0])])]
    want = one["steps"]
    losses = [max(abs(g[k] - w[k]) / abs(w[k]) for k in w if w[k])
              for g, w in zip(got, want)]
    steps = len(want)

    def worst(a, b, trees):
        """(worst relative L2, its tensor) of each tree."""
        return {t: max((_rel(a[t][k], v), k) for k, v in b[t].items())
                for t in trees}
    first = worst(ranks[0]["first"], one["first"], ("mu", "nu"))
    tp_state, one_state = _states(ranks[0]["checkpoint"], one["checkpoint"])
    last = worst(tp_state, one_state, ("mu", "nu"))
    params = max(float((tp_state["params"][k] - v).abs().max())
                 for k, v in one_state["params"].items())
    log(f"{run['name']}: {len(got)} / {steps} steps; each step's loss "
        f"components, worst rel diff {['%.2e' % x for x in losses]} (rtol "
        f"{TP_LOSS_RTOL}); after step 1 (the gathered moments) worst rel L2 "
        f"mu {first['mu'][0]:.3e} ({first['mu'][1]}), nu "
        f"{first['nu'][0]:.3e} ({first['nu'][1]}) (bound "
        f"{TP_MOMENT_REL_L2}); the gathered checkpoint after step {steps}: "
        f"mu {last['mu'][0]:.3e} ({last['mu'][1]}), nu {last['nu'][0]:.3e} "
        f"({last['nu'][1]}) (bound {TP_LAST_MOMENT_REL_L2}), parameters "
        f"worst |diff| {params:.3e} (bound {2 * lr * steps:.1e})")
    if (len(got) != steps or tp_state["step"] != one_state["step"] or
            max(losses) > TP_LOSS_RTOL or
            max(first[t][0] for t in first) > TP_MOMENT_REL_L2 or
            max(last[t][0] for t in last) > TP_LAST_MOMENT_REL_L2 or
            params > 2 * lr * steps * 1.001):
        raise AssertionError(f"{run['name']}: the gathered state differs")


def phase_tp(models, files, data_dir, workdir) -> dict:
    """The tp runs, each against its one-process run; every per-rank kernel
    signature against the plain version; returns the workers' launches."""
    t0 = time.perf_counter()
    for name, p in (("tp_flagship", 0.0), ("tp_flagship_dropout", 0.1)):
        write_config(os.path.join(data_dir, name + ".yml"),
                     dict(DATA_YML, EPOCH_RATIO=[0.25], DROPOUT_P=[p]))
    total = {k: 0 for k in KERNELS}
    sigs = collections.Counter()
    for run in TP_RUNS:
        d = os.path.join(workdir, run["name"])
        os.makedirs(d)
        with contextlib.chdir(d):
            argv = tp_argv(run, files, data_dir)
            one = one32 = None
            if run["entry"] == "predict":
                with launch_window():
                    one32 = dict(zip(("ret", "seen"), tp_entry(
                        run, argv + ["--denoise_precision", "f32"])))["seen"]
            if run["name"] != "tp_train_flagship_dropout":
                t1 = time.perf_counter()
                with launch_window():
                    ret, seen = tp_entry(run, argv)
                one = (_train_result(ret, seen) if run["entry"] == "train"
                       else dict(ret=ret, **seen))
                one_s = time.perf_counter() - t1
                gc.collect()
                torch.cuda.empty_cache()
            ranks = run_tp_workers(run, argv, d)
        secs = max(r["seconds"] for r in ranks)
        log(f"{run['name']}: --mesh {run['mesh']}, {TP_WORLD} ranks on one "
            f"card: {secs:.1f} s a rank" + (f", one process {one_s:.1f} s"
                                             if one is not None else "")
            + f" ({TP_BACKEND})")
        if any(r["backend"] != "gloo" for r in ranks):
            raise AssertionError(f"{run['name']}: not a gloo group")
        if run["entry"] == "predict":
            expected = expected_launches(models, dict(EVAL_PATHS[1], pred=1),
                                         1)
            check_tp_predict(run, ranks, one, one32, expected)
        elif run["entry"] == "fvd":
            # each rank runs every pass of the path on its slice
            check_tp_fvd(run, ranks, one,
                         expected_launches(models, EVAL_PATHS[0], 2))
        else:
            check_tp_train(run, ranks, one, DATA_YML["LR"][0])
            # the f32 flagship's whole states (5.3 GB each) leave the disk
            for res in ranks[:1] + ([one] if one else []):
                shutil.rmtree(res["checkpoint"])
        for res in ranks:
            sigs.update(res["sigs"])
            BODY_LAUNCHES.update(res["bodies"])
            for k in KERNELS:
                total[k] += res["launches"][k]
    # every rank path that reaches a kernel runs it in bf16 on the NHWC
    # body; f32 and the NCHW body are checked at every full-width shape in
    # phase 3, and are left out here (the script's time bound)
    rows = check_signatures(sigs, (torch.bfloat16,), what="tp per-rank: ",
                            nchw=False)
    log(f"tp: {len(rows)} kernel rows at the per-rank shapes agree; "
        f"launches of the {TP_WORLD}-rank runs {total}; "
        f"{time.perf_counter() - t0:.1f} s ({TP_BACKEND})")
    return total


# The quality phase (phase 12): the port's two quality tools at their
# defaults (20 epochs, 14 clips in batches of 7, Phase B at 8 clips of
# 512px) on the Moving-MNIST-layout stand-in (``--dataset mnist``: no cv2
# on the card's machine, so neither the PNG tree nor the text mode).
QUALITY_MODES = ("ar", "diff", "future")
QUALITY_DRIFT_BATCH = 8


def quality_fvd_batches() -> list:
    """The clips of each batch the FVD CLI takes from the stand-in's test
    split (the last 20% of its sequences, one clip each) in the quality
    tools' protocol."""
    seqs = Q.MNIST_SHAPE[0]
    clips = min(seqs - int(seqs * 0.8), G.FVD_CLIPS)
    return [min(G.FVD_BATCH, clips - i) for i in range(0, clips, G.FVD_BATCH)]


def quality_signatures(models) -> dict:
    """Every (kernel, signature) the quality gate hands the dispatchers, by
    phase: a dry run with the plain versions of one UNet call at each of
    Phase A's batches (its bf16 native-grid refiner on the tools' 64px
    frames: 8 x 8 latents; every call has the same shapes) and of one f32
    UNet call and VAE decode at Phase B's 512px batch. The quality modes'
    training and FVD reach no kernel (PixelCodec, no refiner)."""
    by_phase, hw = {}, Q.BALL_CFG["FRAME_SIZE"] // 8
    pipe = SDPipeline(models["vae"], models["unet"], models["clip"])
    pipe32 = G.drift_pipeline("cuda")
    lat, _ = G.drift_inputs(QUALITY_DRIFT_BATCH, "cuda")
    with _kernels.force_reference(), torch.inference_mode():
        emb = pipe.uncond_embeddings(1)[:1]
        with _kernels.record_calls() as rec:
            for b in set(quality_fvd_batches()):
                pipe._unet_eps(torch.zeros(b, 4, hw, hw, device="cuda"),
                               500.0, emb.expand(2 * b, -1, -1), 0.0)
        by_phase["dpmpp_gate_fvd"] = rec.calls
        with _kernels.record_calls() as rec:
            pipe32._unet_eps(lat, 500.0, pipe32.uncond_embeddings(1)[:1]
                             .expand(2 * len(lat), -1, -1), 0.0)
            pipe32.vae.decode(lat)
        by_phase["dpmpp_gate_drift_512"] = rec.calls
    del pipe32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    merged = merge_signatures(by_phase.values())
    log(f"kernel: dry run of the quality gate's two phases (plain versions): "
        f"{ {k: sum(1 for n, _ in merged if n == k) for k in KERNELS} } "
        f"distinct signatures")
    return by_phase


def expected_quality_launches(models) -> tuple[dict, dict]:
    """The quality gate's launches by kernel body, from the models'
    structure: Phase A's three refined arms (DDIM from step 40 of 50: 10
    UNet calls a frame; dpmpp 5 and 4) over 4 predicted frames a batch, bf16
    (``wgmma``); Phase B's 264 f32 UNet calls (dpmpp 64, DDIM 10, DDIM 181,
    dpmpp 5, dpmpp 4) and 3 VAE decodes (``tf32x3``); every GroupNorm on
    the NHWC body."""
    (_, dec_k1, unet_k1), (_, dec_k2, unet_k2) = (
        passes_per_model(models)[k] for k in KERNELS)
    tail = DDIMSchedule(DDIM_STEPS).n_steps - 40
    fvd_calls = (tail + sum(G.DPMPP_STEPS)) * 4 * len(quality_fvd_batches())
    drift_calls = 64 + tail + (1000 - 819) + sum(G.DPMPP_STEPS)
    decodes = 1 + len(G.DPMPP_STEPS)
    bodies = {"wgmma": fvd_calls * unet_k1,
              "tf32x3": drift_calls * unet_k1 + decodes * dec_k1}
    log(f"quality: expected UNet calls {fvd_calls} bf16 (Phase A) + "
        f"{drift_calls} f32 and {decodes} f32 VAE decodes (Phase B): flash "
        f"attention by body {bodies}")
    return {"flash_attention": sum(bodies.values()),
            "groupnorm_silu": (fvd_calls + drift_calls) * unet_k2
            + decodes * dec_k2}, bodies


def _params_distance(path_a, path_b) -> tuple:
    """(largest |a - b|, relative L2) over the parameters two checkpoint
    directories share, and the names only one of them has."""
    a, b = (torch.load(os.path.join(p, "state.pt"), map_location="cpu",
                       weights_only=True)["params"] for p in (path_a, path_b))
    shared = sorted(set(a) & set(b))
    diff = max(float((a[k].double() - b[k].double()).abs().max())
               for k in shared)
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in shared)
    den = sum(float(a[k].double().square().sum()) for k in shared)
    return diff, (num / den) ** 0.5, sorted(set(a) ^ set(b))


@torch.inference_mode()
def rollout_levels(scratch, mode, device="cuda") -> str:
    """What a trained quality mode predicts for the FVD CLI's test clips (4
    frames from 5): the mean pixel level and the share of pixels above 0,
    against the ground truth's. The gate's scores say how far the
    predictions are from the truth; these say whether they hold anything."""
    cfg = load_config(Q.CONFIG, os.path.join(scratch, mode, "configs"))
    args = argparse.Namespace(
        naive=False, train_mode=mode, reference_pe=False, config=Q.CONFIG,
        checkpoint_dir=os.path.join(scratch, mode, "checkpoints"), index=0,
        mode="test", torch_checkpoint=None, codec="pixel", vae_weights=None)
    codec = P.build_codec(cfg, args, device)
    predict = make_predict_fn(P.build_model(cfg, args, device), codec, 4,
                              window=cfg.frames_per_clip, mode=mode,
                              future_horizon=cfg.frames_to_predict)
    data = MovingMNISTDataset(cfg.frames_per_clip + 4, cfg.stride,
                              os.path.join(scratch, "mnist.npy"), "test",
                              seed=0)
    clips = torch.from_numpy(np.stack([data[i][1] for i in range(len(data))]))
    _, preds = predict(clips[:, :cfg.frames_per_clip].to(device))
    got = codec.decode_latents(preds.reshape(-1, preds.shape[-1])).float()
    truth = clips[:, cfg.frames_per_clip:].float()
    return (f"predicted frames: mean level {got.mean():.3f}, "
            f"{(got > 0).float().mean():.4f} of pixels above 0; the truth's "
            f"{truth.mean():.3f} and {(truth > 0).float().mean():.4f}")


def phase_quality(models, workdir) -> dict:
    """The quality tools through their ``main``: each mode trained and
    scored against Identity, then both phases of the dpmpp gate; every gate
    must pass; exact launches by body. Returns the launches."""
    t0 = time.perf_counter()
    scratch = os.path.join(workdir, "quality")
    argv = ["--dataset", "mnist", "--scratch", scratch]
    with launch_window() as window:               # the main path
        rc = Q.main(argv + ["--modes", ",".join(QUALITY_MODES)])
    modes_s = time.perf_counter() - t0
    window.check("quality_modes", {k: 0 for k in KERNELS})
    total = dict(counted(window))
    with open(os.path.join(scratch, "quality_modes.json")) as f:
        results = json.load(f)
    for mode in QUALITY_MODES:
        e = results[mode]
        log(f"quality_modes_{mode}: trained FVD {e['trained']['fvd']:.6f} "
            f"MSE {e['trained']['mse']:.6f}; Identity FVD "
            f"{e['naive']['fvd']:.6f} MSE {e['naive']['mse']:.6f}; "
            f"{e['trained']['clips']} clips; beats Identity "
            f"{'YES' if e['pass'] else 'NO'}; {e['seconds']:.1f} s; "
            f"{rollout_levels(scratch, mode)}")
    ckpt = {m: checkpoint_path(os.path.join(scratch, m, "checkpoints"),
                               Q.CONFIG, 0, "test") for m in ("ar", "future")}
    diff, rel, only = _params_distance(ckpt["ar"], ckpt["future"])
    log(f"quality_modes: future against ar, the trained parameters: "
        f"{'bit-equal' if diff == 0 and not only else 'not equal'}, largest "
        f"|diff| {diff:.3e}, rel L2 {rel:.3e}; in one only: {only}")
    if rc != 0 or not all(results[m]["pass"] for m in QUALITY_MODES):
        raise AssertionError(f"quality_modes: a mode does not beat Identity "
                             f"(exit {rc})")
    expected, bodies = expected_quality_launches(models)
    t1 = time.perf_counter()
    with launch_window() as window:               # the main path
        rc = G.main(argv + ["--drift_batch", str(QUALITY_DRIFT_BATCH)])
    gate_s = time.perf_counter() - t1
    window.check("dpmpp_quality_gate", expected, flash_body=bodies)
    for k, n in counted(window).items():
        total[k] += n
    with open(os.path.join(scratch, "dpmpp_gate.json")) as f:
        report = json.load(f)
    log(f"dpmpp_gate_fvd: " + "; ".join(
        f"{arm} FVD {e['fvd']:.6f} MSE {e['mse']:.6f}"
        for arm, e in report["fvd_arms"].items()) + "; " + "; ".join(
        f"{g}: FVD gap {report[g]['rel_fvd_gap']:+.4f}, MSE gap "
        f"{report[g]['rel_mse_gap']:+.4f} (limit +0.15), "
        f"{'pass' if report[g]['pass'] else 'FAIL'}"
        for g in ("gate_dpmpp5", "gate_dpmpp4")))
    drift = report["drift_512px"]
    log(f"dpmpp_gate_drift_512: " + ", ".join(
        f"{k} {v}" for k, v in drift.items()) + "; " + ", ".join(
        f"err_dpmpp{k}_vs_truth / err_ddim10_vs_truth "
        f"{drift[f'err_dpmpp{k}_vs_truth'] / drift['err_ddim10_vs_truth']:.4f}"
        f" (limit {G.DRIFT_FACTOR})" for k in G.DPMPP_STEPS))
    log(f"quality: the modes {modes_s:.1f} s, the gate {gate_s:.1f} s, the "
        f"phase {time.perf_counter() - t0:.1f} s")
    if rc != 0 or not report["pass"]:
        raise AssertionError(f"dpmpp_quality_gate: a gate failed (exit {rc})")
    return total


# The cli phase (phase 13): the port's benchmark tools at reduced depth, on
# the Moving-MNIST-layout stand-in (``--dataset mnist``: no cv2 here). The
# predict CLI as a child process, in batch mode (CLI_BATCHES batches of
# CLI_STREAMS) and as a server (its warm-up batch and CLI_REQUESTS requests);
# the trainer CLI (CLI_EPOCHS epochs from the native cache); the knee's two
# points the bench phase does not run (1 timed request each); the attention
# tool's six rows. The children run through ``tools/counted``, whose
# COUNTED line carries their launches by body. It runs before the bench
# phase, whose traces raise the host's cost of every later launch.
CLI_STREAMS, CLI_BATCHES, CLI_REQUESTS, CLI_EPOCHS = 8, 2, 2, 2
CLI_KNEE = ("train_bf16_full_b48", "denoise_b16")
CLI_TIMEOUT = 300          # seconds, one child


def check_child(name, counts, expected) -> dict:
    """A child's COUNTED line: launches equal ``expected``, every dispatcher
    call a launch, every flash launch on the ``wgmma`` body and every
    GroupNorm launch on the ``nhwc`` body. Returns its launches, the flash
    ones by body added to ``BODY_LAUNCHES``."""
    launches, bodies = counts["launches"], counts["bodies"]
    log(f"{name}: launches {launches}; by body {bodies}; dispatcher calls "
        f"{counts['calls']}; the path implies {expected}")
    nonzero = lambda d: {k: n for k, n in d.items() if n}
    if launches != expected or counts["calls"] != nonzero(launches):
        raise AssertionError(f"{name}: launches {launches} (dispatcher calls "
                             f"{counts['calls']}), the path implies "
                             f"{expected}")
    if (nonzero(bodies["flash_attention"])
            != nonzero({"wgmma": launches["flash_attention"]})
            or nonzero(bodies["groupnorm_silu"])
            != nonzero({"nhwc": launches["groupnorm_silu"]})):
        raise AssertionError(f"{name}: a launch left its body: {bodies}")
    BODY_LAUNCHES.update(bodies["flash_attention"])
    return launches


def phase_cli(per_batch, checkpoint, workdir) -> dict:
    """The benchmark tools: the CLI children (launches exact, exit 0, their
    ``--timing`` / ``SERVE_READY`` lines read), the knee's points (no
    ``error`` line) and the attention rows (parity at the port's limits).
    ``per_batch``: the launches of one 8-stream 512px DDIM batch;
    ``checkpoint``: the eval phase's flagship checkpoint, which the serving
    tool reads in place of drawing its own (the same widths; None: the tool
    draws one). Returns the launches."""
    from sd_video_gen_tpu_torch.tools import bench_attention as BA
    from sd_video_gen_tpu_torch.tools import bench_cli_serving as CS
    from sd_video_gen_tpu_torch.tools import bench_cli_train as CT
    from sd_video_gen_tpu_torch.tools import bench_knee as KN
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def add(launches):
        for k in KERNELS:
            total[k] += launches[k]

    def times(n):
        return {k: n * v for k, v in per_batch.items()}

    serving = os.path.join(workdir, "cli", "serving")
    ckpt = checkpoint_path(os.path.join(serving, "checkpoints"),
                           CS.CONFIG_NAME, 0, "test")
    if checkpoint is not None:
        os.makedirs(os.path.dirname(ckpt))
        os.symlink(checkpoint, ckpt)
    clips, pred = CLI_STREAMS * CLI_BATCHES, CS.CONFIG["FRAMES_TO_PREDICT"][0]
    paths = CS.prepare(serving, clips, "mnist")
    t = CS.run_cli(paths, clips, CLI_STREAMS, pred, False, CLI_TIMEOUT,
                   counted=True)
    if t["clips"] != clips or not t.get("first_sync_s"):
        raise AssertionError(f"cli_serving: timing payload {t}")
    steady = (clips - CLI_STREAMS) * pred / (t["total_s"]
                                             - t["first_sync_s"])
    log(f"cli_serving batch: {CLI_BATCHES} batches of {CLI_STREAMS} streams, "
        f"steady {steady:.4f} frames/s, with the start-up "
        f"{clips * pred / t['total_s']:.4f}; first sync {t['first_sync_s']} "
        f"s, total {t['total_s']} s, child wall {t['wall_s']} s")
    add(check_child("cli_serving batch", t["launches"], times(CLI_BATCHES)))
    r = CS.run_serve_bench(paths, CLI_STREAMS, pred, CLI_REQUESTS,
                           CLI_TIMEOUT, counted=True)
    log(f"cli_serving serve: ready after {r['server_ready_wall_s']} s "
        f"(warm-up {r['server_warmup_s']} s), TTFF {r['ttff_warm_server_s']}"
        f" s, latencies {r['request_latencies_s']} s, steady "
        f"{r['steady_fps']} frames/s")
    add(check_child("cli_serving serve", r["launches"],
                    times(1 + CLI_REQUESTS)))

    train = os.path.join(workdir, "cli", "train")
    tpaths = CT.prepare(train, CLI_EPOCHS, "mnist")
    CT.build_cache(tpaths)
    run = CT.run_trainer(train, tpaths, "bf16_full", CLI_TIMEOUT,
                         counted=True)
    summary = CT.summarize(run["rows"], "bf16_full", run["wall_s"])
    log(f"cli_train: {json.dumps(summary)}")
    add(check_child("cli_train", run["launches"], dict.fromkeys(KERNELS, 0)))
    shutil.rmtree(tpaths["checkpoints"])    # the flagship's state, GBs

    for case, scenario, kwargs in KN.points("all"):
        if case in CLI_KNEE:
            line = KN.run_point(case, scenario, kwargs, repeats=1)
            if "error" in line:
                raise AssertionError(f"bench_knee: {line}")
            add({k: sum(v.values())
                 for k, v in line["launches_in_run"].items()})
            BODY_LAUNCHES.update(line["launches_in_run"]["flash_attention"])

    rows = len(BA.SHAPES) * len(BA.DTYPES)
    per_row = 1 + (1 + BA.TIMED_CHAINS) * BA.REPEATS
    with launch_window() as window:
        lines = BA.run("cuda")
    window.check("bench_attention", {"flash_attention": rows * per_row,
                                     "groupnorm_silu": 0},
                 flash_body={"wgmma": rows // 2 * per_row,
                             "tf32x3": rows // 2 * per_row})
    missed = [x for x in lines if "ok" in x and not x["ok"]]
    if missed:
        raise AssertionError(f"bench_attention: parity missed: {missed}")
    # each row's parity launch compares the kernel with its plain version:
    # not a main-path launch
    timed = {"wgmma": rows // 2 * (per_row - 1),
             "tf32x3": rows // 2 * (per_row - 1)}
    BODY_LAUNCHES.update(timed)
    add({"flash_attention": sum(timed.values()), "groupnorm_silu": 0})
    log(f"cli: launches {total}; {time.perf_counter() - t0:.1f} s")
    return total


BENCH_REPEATS = 2      # timed requests a scenario (the CLI takes 5)


def phase_bench() -> dict:
    """The benchmark's ten scenarios in this process; a scenario that fails
    fails the run. Returns their launches (every window of both passes),
    the flash ones by body added to ``BODY_LAUNCHES``."""
    from sd_video_gen_tpu_torch import bench
    t0 = time.perf_counter()
    results = {}
    failed = bench.run(bench.select([]), repeats=BENCH_REPEATS,
                       results=results)
    if failed:
        raise AssertionError(f"bench: scenarios failed: {failed}")
    total = {k: 0 for k in KERNELS}
    for rec in results.values():
        for k, bodies in rec["launches_in_run"].items():
            total[k] += sum(bodies.values())
        BODY_LAUNCHES.update(rec["launches_in_run"]["flash_attention"])
    log(f"bench: {len(results)} scenarios, {BENCH_REPEATS} timed requests "
        f"each, in {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def print_totals(launches, what: str) -> None:
    log(f"launches {what}: flash attention {launches['flash_attention']} "
        f"({ {b: BODY_LAUNCHES.get(b, 0) for b in FLASH_BODIES} }), "
        f"GroupNorm {launches['groupnorm_silu']}")


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``, from a CUDA graph of ``calls``
    calls replayed ``replays`` times: no host time in it, which an eager
    loop cannot give under ~0.03 ms a call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def phase_tune(sigs):
    """The rule that picks the NHWC body's mode (``plan_for`` in
    csrc/groupnorm_silu_nhwc.cu) against the alternatives, at every bf16
    GroupNorm signature of the two 512px refiner paths: the body as planned,
    each mode pinned, and the NCHW body on a contiguous copy, timed inside CUDA graphs
    (the same tensor again and again, so one that fits the L2 cache is read
    from there), then calls x ms over one batch of each path."""
    dtype = torch.bfloat16
    sums = collections.defaultdict(lambda: collections.Counter())
    for (name, sig), calls in sigs.items():
        if name != "groupnorm_silu":
            continue
        shape, _, groups, eps, silu, _ = sig
        B, C, H, W = shape
        g = torch.Generator(device="cuda").manual_seed(0)
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(
            dtype).contiguous(memory_format=torch.channels_last)
        w = (1 + 0.5 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        b = (0.5 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        ref = groupnorm_silu_reference(x, w, b, groups, eps, silu)
        rtol, atol = 2 ** -7, 1e-5      # two bf16 roundings, ref's and out's
        ms = {}
        for mode in (None, "cluster", "streaming"):
            try:
                gn.nhwc_plan(B, C, H * W, groups, dtype, mode=mode)
            except ValueError:          # no cluster holds a unit
                continue
            run = lambda: gn._launch(x, w, b, groups, eps, silu, mode)
            if not bool(((run().float() - ref.float()).abs()
                         <= rtol * ref.float().abs() + atol).all()):
                raise AssertionError(f"tune: mode {mode} disagrees with the "
                                     f"plain version at {shape}")
            ms[mode or "planned"] = graph_ms(run)
        del ref
        xc = x.contiguous()
        ms["nchw"] = graph_ms(
            lambda: groupnorm_silu(xc, w, b, groups, eps, silu))
        del xc
        ms["bound"] = (2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
                       * 1e3)
        plan = gn.nhwc_plan(B, C, H * W, groups, dtype)
        ms["best"] = min(v for k, v in ms.items() if k in ("cluster",
                                                           "streaming"))
        log(f"tune: {tuple(shape)} {groups} {eps} {silu} x{calls}: planned "
            f"{ms['planned']:.4f} ms ({plan['mode']}, "
            f"{plan['groups_per_unit']} groups per unit, cluster of "
            f"{plan['cluster']}, tile {plan['tile_bytes']}), "
            + ", ".join(f"{k} {ms[k]:.4f}" if k in ms else f"{k} does not fit"
                        for k in ("cluster", "streaming", "nchw", "bound")))
        path = "B=1" if B == 1 else "B=8"
        for k, v in ms.items():
            sums[path][k] += calls * v
        sums[path]["cluster where it fits, else streaming"] += calls * ms.get(
            "cluster", ms["streaming"])
        torch.cuda.empty_cache()
    for path, total in sums.items():
        log(f"tune: {path} path, calls x ms over one batch: "
            + ", ".join(f"{k} {v:.2f}" for k, v in total.items()
                        if k != "cluster"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tune", action="store_true",
                        help="also time the GroupNorm NHWC body's modes at "
                             "every shape of the 512px refiner paths")
    parser.add_argument("--tp-worker", nargs=5, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.tp_worker:
        return tp_worker(*args.tp_worker)
    strict_f32()
    t0 = time.perf_counter()

    def mark(name):
        log(f"phase {name}: starts at {time.perf_counter() - t0:.1f} s")
    phase_device()
    with tempfile.TemporaryDirectory(prefix="sdvg") as workdir:
        eval_dir = os.path.join(workdir, "eval")
        os.makedirs(eval_dir)
        sd_files = start_sd_weight_files(eval_dir)
        try:
            phase_build()
            models = mode_models(full_width_models(), FLAGSHIP)
            files = eval_files(models, eval_dir)
            sigs = path_signatures(models)
            sigs.update(eval_signatures(files))
            sigs.update(quality_signatures(models))
            mark("kernel")
            summary = phase_kernel(merge_signatures(sigs.values()))
            launches = {k: 0 for k in KERNELS}
            mark("serve")
            for path in PATHS:
                for k, n in phase_serve(models, path).items():
                    launches[k] += n
            mark("sd")
            sd_launches_, sd = phase_sd(models)
            for k, n in sd_launches_.items():
                launches[k] += n
            mark("check")
            phase_check(models)
            mark("jit")
            for k, n in phase_jit(models, sd, workdir).items():
                launches[k] += n
            del sd
            mark("train")
            train_launches, flagship = phase_train(models, workdir)
            eval_launches = phase_eval(models, files, sd_files, flagship)
            del flagship
            data_dir = os.path.join(workdir, "data")
            os.makedirs(data_dir)
            with contextlib.chdir(data_dir):      # the trainer logs to ./logs
                data_launches = phase_data(data_dir)
            tp_dir = os.path.join(workdir, "tp")
            os.makedirs(tp_dir)
            mark("tp")
            tp_launches = phase_tp(models, files, data_dir, tp_dir)
            quality_launches = phase_quality(models, workdir)
            # one 8-stream DDIM batch at 512px: the launches do not depend
            # on the batch
            per_batch = expected_launches(
                models, next(p for p in PATHS
                             if p["name"] == "vae_denoise_ar4"), 1)
            del models                      # the children need the memory
            gc.collect()
            torch.cuda.empty_cache()
            mark("cli")
            cli_launches = phase_cli(per_batch, checkpoint_path(
                files["checkpoints"], EVAL_CONFIG, 0, "test"), workdir)
            for k in KERNELS:
                launches[k] += (train_launches[k] + eval_launches[k]
                                + data_launches[k] + tp_launches[k]
                                + quality_launches[k] + cli_launches[k])
            print_totals(launches, "outside the bench phase")
            mark("bench")
            for k, n in phase_bench().items():
                launches[k] += n
            if args.tune:
                phase_tune(merge_signatures(sigs[name]
                                            for name in REFINER_PATHS))
        finally:
            if sd_files.poll() is None:
                sd_files.kill()
                sd_files.wait()
    log(f"total {time.perf_counter() - t0:.1f} s")
    by_body = {b: BODY_LAUNCHES.get(b, 0) for b in FLASH_BODIES}
    if sum(by_body.values()) != launches["flash_attention"]:
        raise AssertionError(f"flash launches by body {by_body} do not sum "
                             f"to {launches['flash_attention']}")
    summary["flash_attention"]["launches_by_body"] = by_body
    hot32 = max(TRAIN_F32_ROWS, key=lambda r: r["ms"])
    summary["flash_attention"]["f32"] = {
        k: hot32[k] for k in ("shape", "route", "max_abs_err", "ms", "fma_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", **KERNELS[k], "launches": launches[k],
         **summary[k]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
