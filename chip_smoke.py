"""Drive the PyTorch port (``sd_video_gen_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--tune]
    python3 chip_smoke.py --cards 4 [--runs NAME,...]

Phases (any failure ends the run with a non-zero exit; there is no CPU path;
``--cards 4`` runs phases 1, 2 and 11 only, phase 11 on four cards):

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
              they must equal the launches a request counts; then the
              training side: each of the three training paths of phase 8
              (a Trainer of its own, freed after), 3 compiled steps
              (``step_impl``: one CUDA graph, the parameters and Adam's
              moments updated in place inside it, dropout on from a
              generator registered with the capture) against 3 steps under
              ``disable_jit`` from the same state, on three batches:
              loss components, parameters and both moments bit for bit,
              each step's launches by body equal eager's; ``eval_impl``
              compiled against eager; ``train_ref_artifact``'s step graph
              captured in debug mode and dumped, its K1
              (``flash_fwd_tf32x3``) and K2 kernel nodes equal to a replay's
              counted launches
  8. train    three training paths through the port's ``Trainer`` (names and
              sizes are the JAX bench's; every step after the first a
              replay of its compiled step), each 2 warm-up optimizer steps, 8
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
              the FVD CLI runs compiled (its predictor, decode and I3D) and
              once more under ``disable_jit``: FVD, MSE and every batch's
              I3D statistics bit for bit; ``Trainer.fvd_validation`` on
              ``train_flagship``'s Trainer, both protocols, each batch one
              compiled program (``fvd_batch``) against the same eagerly,
              statistics bit for bit and the FVD identical; I3D on the card
              against the CPU
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
              --num_processes 1`` (one NCCL group, compiled: the step's
              graph holds the gradient all-reduce): losses and the saved
              state bit-equal to the first run's, both compiling their step
              and eval, one gradient all-reduce a step; and a few
              ``--train_mode text`` steps from a labelled
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
              frame refined from DDIM step 48; 4 clips, whose 512px VAE mid
              block splits its batch over the ranks, and 3 clips, which
              take the ring), predicted latents and frames against the
              one-process run in bf16 and in f32;
              ``predict_fvd.main --mesh data=4`` (``fvd_native_ar4``, one
              batch of 8 clips), FVD, MSE and the real clips' statistics;
              ``train/trainer.main --mesh data=2,model=2`` from phase 10's
              frame cache at the flagship's widths, f32, 2 steps at dropout
              0 (losses and the gathered checkpoint against one process)
              and 1 step at dropout 0.1 (the replicated parameters bit-equal
              on every rank); ``predict.main --serve SOCK --mesh
              data=2,model=2`` at the same depth, 2 clips a batch: a client
              here sends a warm request and 2 more (one ragged), then each
              rank runs the batch CLI under the same mesh on the same clips
              (every reply equal to its frames bit for bit, and within
              TP_PREDICT_OVER_BF16 of one process).
              Every worker program runs eagerly: the card's backend does
              not capture over gloo, and the workers record their
              signatures; no worker compiles (asserted). With ``--cards
              4`` each worker takes its own card in an NCCL group and runs
              its entry point compiled, then eagerly (bit for bit against
              the compiled run, with equal launches, routes and
              all-reduces; the step's graph holds the gradient
              all-reduce); the one-process references compile on card 0
              (the f32 predict references run too); the predict runs take
              3 batches (12 clips in 4s, 9 in 3s); the train runs add a
              data=4 run at 6 clips a card, held against an f64 step of
              one process on the 24 and against one process that takes the
              mean gradient of the 4 slices (TP_F64_FACTOR), and
              ``train_flagship`` at data=4 (bf16, dropout 0.1, 6 clips a
              card, 3 epochs) against the same on one card; two served runs
              of the main path (``predict_cli_denoise_ar4`` at full depth:
              ``tp_serve_model4``, data=1,model=4, 1 clip a request, and
              ``tp_serve_data4``, data=4, 8 clips, two a rank; a warm
              request and 4 timed ones), replies bit-equal to the same
              mesh's batch CLI, their ``ready_s``, latencies and steady
              frames/s printed; each run's
              compiled, eager and one-card seconds and warm rates (null
              where the window holds a compile or no warm step) are
              printed, and JSON on the line before the last; ``--runs``
              takes a subset of the runs by name (the build, models and
              files only where a predict or FVD run needs them). Launches per
              rank exact (the ring's
              calls run no kernel), every per-rank kernel signature held
              against the plain version in bf16 (not timed), the dtype of
              every rank path that reaches a kernel, on the body the paths
              take (f32 and the
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
              this process: one scenario of each kind (BENCH_SCENARIOS: pixel
              serving, denoised serving, training; the JAX bench's names and
              sizes; phases 4, 7 and 8 drive every path of the others), each
              warmed up (a serving request is one compiled
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
import faulthandler
import gc
import io
import json
import os
import re
import shutil
import signal
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
from sd_video_gen_tpu_torch.tools import split_check
from sd_video_gen_tpu_torch.tools.bench_harness import (
    BF16_FLOPS, CONTEXT, DDIM_STEPS, F32_FLOPS, FLAGSHIP, FRAME,
    COUNTED, HBM_BYTES_PER_S, HI_RES, KERNELS, PATH_DEFAULTS, PATHS, REFINER_PATHS,
    SD_GUIDANCE, SD_PATHS, SD_RUNS, TF32_FLOPS, TRAIN_FRAME, TRAIN_PATHS,
    TRAIN_TIMED, TRAIN_WARMUP, assert_finite, build_models, card,
    expected_launches, full_width_models, launch_window, log, make_trainer,
    passes_per_model, predict_fn, train_frames, wrapper_host_cost)
from sd_video_gen_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     save_checkpoint)
from sd_video_gen_tpu_torch.train import optim
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
# Phase jit: each training path's step compiled against eager, this many
# steps from one state, a batch of other frames each, dropout on.
JIT_TRAIN_STEPS = 3


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


def check_attention(sig, dtype, timing=True) -> dict:
    shape, _, scale = sig
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    out = flash_attention(q, k, v, scale)
    ref = reference_attention(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    body = route(dtype, shape[2], (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    atol = TF32X3_ATOL if body == "tf32x3" else ATTN_ATOL[dtype]
    if not timing:
        return dict(max_abs_err=err, ok=err <= atol, route=body)
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
    extra = {}
    if dtype == torch.float32:
        extra = dict(cuda_core_ms=ops / F32_FLOPS * 1e3, tc_err=tc_err,
                     fma_ms=cuda_ms(lambda: fma_body(q, k, v, scale),
                                    max(3, min(20, int(25 / ms)))))
    return dict(max_abs_err=err, ok=err <= atol, ms=ms,
                plain_ms=plain_ms, route=body,
                tflops=ops / ms / 1e9, library_ms=sdpa_ms,
                bound_ms=max(flops_ms, bytes_ms),
                bound_by="operations" if flops_ms >= bytes_ms else "bytes",
                **extra)


def check_groupnorm(sig, dtype, body, timing=True) -> dict:
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
    if not timing:
        return dict(max_abs_err=err, ok=ok, route=body)
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


def check_signatures(sigs, dtypes, what: str = "", nchw: bool = True,
                     timing: bool = True) -> list:
    """Each kernel at each signature of ``sigs`` in each of ``dtypes``
    against its plain version, timed (unless ``timing`` is False), Adam's
    groups in the dtypes they were recorded in, untimed
    (``check_adam_group``); fails on any disagreement. ``nchw=False``
    leaves out the GroupNorm NCHW body, which no path takes."""
    rows, failures = [], []
    for (name, sig), calls in sigs.items():
        if name == optim.KERNEL:      # a group as recorded, in its dtypes
            shapes, dtype, mu_dtype = sig
            rows.extend(dict(r, kernel=name) for r in check_adam_group(
                f"{what}a group called {calls} times",
                {str(i): s for i, s in enumerate(shapes)},
                dtype, mu_dtype))
            continue
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
                res = (check_attention(sig, dtype, timing) if body is None
                       else check_groupnorm(sig, dtype, body, timing))
                row = dict(kernel=name, shape=list(sig[0]),
                           args=[str(a) for a in sig[2:5]],
                           dtype=str(dtype).split(".")[-1], calls=calls,
                           on_path=body != "nchw", **res)
                rows.append(row)
                if not row["ok"]:
                    failures.append(row)
                if not timing:
                    log(f"kernel: {what}{name} {tuple(sig[0])} {row['args']} "
                        f"{row['dtype']} x{calls}: err "
                        f"{row['max_abs_err']:.2e} "
                        f"{'ok' if row['ok'] else 'FAIL'}, route "
                        f"{row['route']} (not timed)")
                    continue
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
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return rows


# Adam's one-pass kernel against its plain version (the foreach passes):
# a table with ragged tails, one element, a 12.6M fused projection and a
# parameter without gradient, in each dtype pair; then every group a path
# hands the kernel, at its own tensors' shapes (``check_adam_group``).
ADAM_SHAPES = {"one": (1,), "tail": (13,), "qkv": (6144, 2048),
               "ragged": (1000003,), "small": (33, 7), "bias": (2048,),
               "unused": (5, 3)}
ADAM_PAIRS = ((torch.float32, None), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16))
ADAM_ROWS = []       # every group's rows, for the kernels line


def _adam_updates(params, grads, mu_dtype, plain: bool, graph: bool):
    """Three updates of copies of ``params`` by ``grads``: eagerly, or
    captured once into a CUDA graph and replayed with each step's bias
    corrections and gradients filled in between (the compiled step's way);
    under ``force_reference`` where ``plain``. Returns the parameters, the
    state and the launches counted."""
    opt = Adam(1e-3, mu_dtype=mu_dtype)
    p = {k: v.clone() for k, v in params.items()}
    state = opt.init(p)
    before = _kernels.LAUNCHES[optim.KERNEL]
    if not graph:
        with (_kernels.force_reference() if plain
              else contextlib.nullcontext()):
            for count, g in enumerate(grads, start=1):
                opt.update(p, g, state, count)
    else:
        scratch = {k: v.clone() for k, v in p.items()}   # the warm-up
        opt.update(scratch, grads[0], opt.init(scratch), 1)
        del scratch
        torch.cuda.synchronize()
        before = _kernels.LAUNCHES[optim.KERNEL]
        static = {k: None if g is None else torch.zeros_like(g)
                  for k, g in grads[0].items()}
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            opt.update(p, static, state)
        for count, g in enumerate(grads, start=1):
            for k, t in static.items():
                if t is not None:
                    t.copy_(g[k])
            opt.set_count(p, state, count)
            cuda_graph.replay()
    torch.cuda.synchronize()
    return p, state, _kernels.LAUNCHES[optim.KERNEL] - before


def check_adam_group(what, shapes, dtype, mu_dtype, unused=()) -> list:
    """The kernel against the foreach passes on one group: parameters of
    ``shapes`` (name -> shape) in ``dtype`` drawn on the card, moments in
    ``mu_dtype`` (None: the parameters'), three updates by gradients of
    three scales (none for the names in ``unused``), eagerly and in a
    graph's replay: p, mu and nu bit for bit, the launches the group's plan
    gives (each update, or the capture once), a parameter without gradient
    and its moments untouched. Returns a row a way, kept in ``ADAM_ROWS``;
    raises on any difference."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    draw = lambda s, scale: (torch.randn(s, generator=gen, device="cuda")
                             * scale).to(dtype)
    params = {k: draw(s, 0.02) for k, s in shapes.items()}
    grads = [{k: None if k in unused else draw(s, scale)
              for k, s in shapes.items()} for scale in (1.0, 1e-3, 10.0)]
    numels = [int(np.prod(s)) for k, s in shapes.items() if k not in unused]
    per = len(optim.launch_plan(numels, 16 // dtype.itemsize,
                                _kernels.library().sdvg_adam_max_tensors()))
    want = _adam_updates(params, grads, mu_dtype, True, False)
    rows = []
    for graph in (False, True):
        got = _adam_updates(params, grads, mu_dtype, False, graph)
        diff = {f"{tree} {k}": int((a[k] != b[k]).sum())
                for tree, a, b in (("p", got[0], want[0]),
                                   ("mu", got[1]["mu"], want[1]["mu"]),
                                   ("nu", got[1]["nu"], want[1]["nu"]))
                for k in a}
        untouched = all(torch.equal(got[0][k], params[k])
                        and not got[1]["mu"][k].any()
                        and not got[1]["nu"][k].any() for k in unused)
        row = dict(what=what, tensors=len(shapes), parameters=sum(numels),
                   dtype=str(dtype).split(".")[-1],
                   mu_dtype=str(next(iter(got[1]["mu"].values())).dtype)
                   .split(".")[-1],
                   way="graph replay" if graph else "eager",
                   launches=got[2], plain_launches=want[2],
                   differ=sum(diff.values()), untouched=untouched)
        row["ok"] = (row["differ"] == 0 and untouched and want[2] == 0
                     and got[2] == per * (1 if graph else len(grads)))
        log(f"kernel: adam {what}: {row['dtype']}/{row['mu_dtype']} "
            f"{row['way']}, 3 updates of {len(shapes)} tensors, "
            f"{row['parameters']} parameters: {row['differ']} elements "
            f"differ from the plain version "
            f"{ {k: n for k, n in diff.items() if n} }"
            + (f", unused parameter {'untouched' if untouched else 'MOVED'}"
               if unused else "")
            + f", launches {got[2]} (plain {want[2]}) "
            f"{'ok' if row['ok'] else 'FAIL'}")
        rows.append(row)
        del got
    del params, grads, want
    torch.cuda.empty_cache()
    ADAM_ROWS.extend(rows)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"adam: the kernel left its plain version: "
                             f"{bad}")
    return rows


def check_adam() -> None:
    """``check_adam_group`` on ``ADAM_SHAPES`` in each dtype pair."""
    for dtype, mu_dtype in ADAM_PAIRS:
        check_adam_group("table", ADAM_SHAPES, dtype, mu_dtype,
                         unused=("unused",))


def check_trainer_adam(name, trainer) -> None:
    """``check_adam_group`` on each group ``trainer``'s step hands the
    kernel: its parameters' shapes in their dtypes and their moments'."""
    state = trainer.state
    groups = collections.defaultdict(dict)
    for k, p in state.params.items():
        groups[(p.dtype, state.opt_state["mu"][k].dtype)][k] = tuple(p.shape)
    for (dtype, mu_dtype), shapes in groups.items():
        check_adam_group(name, shapes, dtype, mu_dtype)


def time_adam() -> dict:
    """One update of ``train_flagship``'s transformer (bf16 parameters and
    moments, 200 tensors) by the kernel and by its plain version, each
    captured into a CUDA graph as the compiled step holds it (an eager
    call's host work, ~1-3 ms for 200 tensors, would be timed instead)
    and replayed in turns (once each from the same state first: p, mu and
    nu compared bit for bit), and, as the yardstick only,
    ``torch.optim.Adam(fused=True)`` (never on the port's path), eager;
    CUDA events. The bound is one read of p, g, mu, nu and one write of p,
    mu, nu at the card's bandwidth."""
    model = build(FrameTransformer, FrameTransformerConfig.from_config(
        TRAIN_PATHS[0]["cfg"]), "meta", torch.bfloat16, trainable=True)
    shapes = [p.shape for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = {str(i): (torch.randn(s, generator=gen, device="cuda")
                       * 0.02).bfloat16() for i, s in enumerate(shapes)}
    grads = {k: (torch.randn(v.shape, generator=gen, device="cuda")
                 * 1e-3).bfloat16() for k, v in params.items()}
    opt = Adam(1e-5, mu_dtype=torch.bfloat16)
    state = opt.init(params)
    opt.set_count(params, state, 1)
    numel = sum(p.numel() for p in params.values())

    def captured(plain: bool):
        with _kernels.force_reference() if plain else \
                contextlib.nullcontext():
            opt.update(params, grads, state)        # warm-up
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                opt.update(params, grads, state)
        return graph
    kernel, plain = captured(False), captured(True)
    # each graph replayed once from the same state: the main path's group
    # bit for bit through both
    live = [*params.values(), *state["mu"].values(), *state["nu"].values()]
    start, ends = [t.clone() for t in live], []
    for graph in (kernel, plain):
        for t, s in zip(live, start):
            t.copy_(s)
        graph.replay()
        ends.append([t.clone() for t in live])
    differ = sum(int((a != b).sum()) for a, b in zip(*ends))
    moved = sum(int((a != b).sum()) for a, b in zip(ends[0], start))
    del start, ends
    if differ or not moved:
        raise AssertionError(f"adam: at train_flagship's group the kernel's "
                             f"replay moved {moved} elements of p, mu and "
                             f"nu and left the plain version's in {differ}")
    fused_params = [v.clone().requires_grad_(True) for v in params.values()]
    for p, g in zip(fused_params, grads.values()):
        p.grad = g
    fused = torch.optim.Adam(fused_params, lr=1e-5, fused=True)
    ms, plain_ms = timed(plain.replay, kernel.replay)
    library_ms = cuda_ms(fused.step, 5)
    nbytes = numel * 2 * 7          # p, g, mu, nu read; p, mu, nu written
    out = dict(tensors=len(shapes), parameters=numel, differ=differ, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               gbps=nbytes / ms / 1e6)
    log(f"kernel: adam at train_flagship's {numel} bf16 parameters in "
        f"{len(shapes)} tensors: a replay moved {moved} elements of p, mu "
        f"and nu, each bit for bit as the plain version's replay; "
        f"{ms:.4f} ms ({out['gbps']:.0f} GB/s), plain (foreach) "
        f"{plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"(bytes; {out['bound_ms'] / ms:.0%} of it reached), library "
        f"(yardstick, not a port) torch.optim.Adam(fused=True) "
        f"{library_ms:.4f} ms")
    del params, grads, state, fused, fused_params, kernel, plain
    torch.cuda.empty_cache()
    return out


def phase_kernel(sigs) -> dict:
    log(f"kernel: tensor cores' f32 sums of exact TF32 products (cuBLAS, "
        f"TF32 on): {tensor_core_rounding():.4f} of those off the exact sum "
        f"lie nearer zero")
    rows = check_signatures(sigs, (torch.bfloat16, torch.float32))
    log_wrapper_host_cost()
    check_adam()
    summary = {optim.KERNEL: time_adam()}
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
    total, compiles = dict.fromkeys(COUNTED, 0), {}
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
    expected = {optim.KERNEL: 0, **expected}     # a request trains nothing
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
             "gn_nhwc_stats", "gn_nhwc_apply",
             "sdvg_adam_multi_tensor_apply_kernel")
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


def _state_copy(trainer) -> dict:
    sd = trainer.state.state_dict()
    return {"step": sd["step"], **{tree: {k: v.clone()
                                          for k, v in sd[tree].items()}
                                   for tree in ("params", "mu", "nu")}}


def _same_trees(trainer, copy_) -> bool:
    sd = trainer.state.state_dict()
    return sd["step"] == copy_["step"] and all(
        torch.equal(v, copy_[tree][k]) for tree in ("params", "mu", "nu")
        for k, v in sd[tree].items())


def _train_steps(trainer, batches) -> list:
    """One ``Trainer.train_loop`` step a batch, each in a launch window:
    (loss components, window, wall s, CUDA-event ms) of each."""
    out = []
    for b in batches:
        with launch_window() as window:
            m, wall, ms = timed_request(lambda: trainer.train_loop([b]))
        out.append(({k: v for k, v in m.items() if k.endswith("_train")},
                    window, wall, ms))
    return out


def jit_train_path(path, workdir, per_step) -> dict:
    """A training path's step compiled (``step_impl``: its first call
    compiles, then every call replays) against the same steps under
    ``disable_jit`` from the same state: loss components, parameters and
    both moments bit for bit after JIT_TRAIN_STEPS steps with dropout on,
    one graph, each step's launches by body equal eager's and
    ``per_step``; ``eval_impl`` on the first batch, compiled against eager.
    ``train_ref_artifact``'s step is captured in debug mode, its graph
    dumped and its K1 (``flash_fwd_tf32x3``) and K2 kernel nodes counted
    against a replay's launches."""
    name, cfg = path["name"], path["cfg"]
    trainer = make_trainer(path, workdir)
    start = _state_copy(trainer)
    batches = [([0] * cfg.batch_size, train_frames(path, seed=s))
               for s in range(JIT_TRAIN_STEPS)]
    dump = name == "train_ref_artifact"
    # compiled first: cuDNN keeps, for each convolution shape, the
    # algorithm it last ran, and a capture may take another than an eager
    # call before it did; eager calls after the capture run the captured one
    J.BACKEND.debug = dump
    try:
        compiled = _train_steps(trainer, batches)
    finally:
        J.BACKEND.debug = False
    program = trainer._step_fn.impl
    after = _state_copy(trainer)
    trainer.state.load_state_dict(start)
    with J.disable_jit():
        eager = _train_steps(trainer, batches)
    same = _same_trees(trainer, after)
    del after
    frames = torch.from_numpy(batches[0][1]).cuda()
    with launch_window() as ev_c:
        ev = trainer._eval_fn(frames)
    with J.disable_jit(), launch_window() as ev_e:
        ev_eager = trainer._eval_fn(frames)
    body = "tf32x3"
    for i, (c, e) in enumerate(zip(compiled, eager)):
        got, want = ((w.launches, w.bodies, w.gn_bodies) for w in (c[1], e[1]))
        if got != want or c[1].launches[optim.KERNEL] != 1:   # one group
            raise AssertionError(f"jit: {name} step {i + 1}: launches "
                                 f"compiled {got}, eager {want}")
        c[1].check(f"{name} step {i + 1} (compiled)", per_step, body)
    ev_same = all(torch.equal(ev[k], ev_eager[k]) for k in ev_eager)
    if (ev_c.launches, ev_c.bodies, ev_c.gn_bodies) != (
            ev_e.launches, ev_e.bodies, ev_e.gn_bodies):
        raise AssertionError(f"jit: {name} eval_impl: launches compiled "
                             f"{ev_c.launches}, eager {ev_e.launches}")
    ev_c.check(f"{name} eval_impl (compiled)", per_step, body)
    comps_same = [c[0] for c in compiled] == [e[0] for e in eager]
    if not (same and comps_same and ev_same and program.n_graphs == 1
            and trainer.state.step == JIT_TRAIN_STEPS):
        raise AssertionError(
            f"jit: {name}: compiled against eager: state equal {same}, loss "
            f"components equal {comps_same} ({[c[0] for c in compiled]} / "
            f"{[e[0] for e in eager]}), eval equal {ev_same}, graphs "
            f"{program.n_graphs}, steps {trainer.state.step}")
    nodes = None
    if dump:
        dot = os.path.join(workdir, "train_step.dot")
        (graph,) = program.graphs()
        graph.debug_dump(dot)
        nodes = graph_kernel_nodes(dot)
        os.unlink(dot)
        want = compiled[-1][1].launches            # a replay's
        k2 = nodes["gn_nhwc_cluster"] + nodes["gn_nhwc_stats"]
        log(f"jit: {name} step graph (debug_dump): {nodes['all']} nodes; K1 "
            f"flash_fwd_tf32x3 {nodes['flash_fwd_tf32x3']}, wgmma "
            f"{nodes['flash_fwd_wgmma']}; K2 gn_nhwc_cluster "
            f"{nodes['gn_nhwc_cluster']}, gn_nhwc_stats "
            f"{nodes['gn_nhwc_stats']}, gn_nhwc_apply "
            f"{nodes['gn_nhwc_apply']}; Adam "
            f"{nodes['sdvg_adam_multi_tensor_apply_kernel']}; a replay's "
            f"counted launches {want}")
        if (nodes["flash_fwd_tf32x3"] != want["flash_attention"]
                or nodes["flash_fwd_wgmma"] or k2 != want["groupnorm_silu"]
                or nodes["gn_nhwc_apply"] != nodes["gn_nhwc_stats"]
                or nodes["sdvg_adam_multi_tensor_apply_kernel"]
                != want[optim.KERNEL]
                or not want["flash_attention"]):
            raise AssertionError(f"jit: {name}: the step graph's kernel "
                                 f"nodes {dict(nodes)} are not the counted "
                                 f"launches {want}")
    rec = next(c for c in reversed(J.COMPILES) if c["name"] == "step_impl")
    replays = compiled[1:]
    res = dict(
        compile_s=rec["warmup_s"] + rec["capture_s"],
        compiled_wall_ms=float(np.mean([c[2] for c in replays])) * 1e3,
        device_ms=float(np.mean([c[3] for c in replays])),
        eager_wall_ms=float(np.mean([e[2] for e in eager[1:]])) * 1e3,
        eager_span_ms=float(np.mean([e[3] for e in eager[1:]])),
        replay_ms=program.replay_ms(),
        launches={k: sum(c[1].launches[k] for c in compiled)
                  + ev_c.launches[k] for k in COUNTED})
    res["compiled_idle"] = 1 - res["device_ms"] / res["compiled_wall_ms"]
    res["eager_idle"] = 1 - res["device_ms"] / res["eager_wall_ms"]
    for c in compiled:
        counted(c[1])
    counted(ev_c)
    log(f"jit: {name}: {JIT_TRAIN_STEPS} compiled steps == {JIT_TRAIN_STEPS} "
        f"eager steps bit for bit (dropout_p {cfg.dropout_p}: loss "
        f"components, parameters, both moments), one graph; eval_impl "
        f"compiled == eager; launches a step {compiled[-1][1].launches} by "
        f"body {compiled[-1][1].bodies} {compiled[-1][1].gn_bodies}, eager's "
        f"the same; a replayed step: wall {res['compiled_wall_ms']:.2f} ms, "
        f"device {res['device_ms']:.2f} ms (CUDA events; replay "
        f"{res['replay_ms']:.2f} ms), idle {res['compiled_idle']:.1%}; "
        f"eager step: wall {res['eager_wall_ms']:.2f} ms (events span "
        f"{res['eager_span_ms']:.2f} ms), idle {res['eager_idle']:.1%} "
        f"against the compiled device ms; compile (warm-up, undone, + "
        f"capture) {res['compile_s']:.2f} s")
    return res


def phase_jit(models, sd, workdir) -> dict:
    """Every phase-4 serving path and phase-5 SD path compiled against eager
    (``check_compiled``), then the graph dump of the B=8 DDIM refiner;
    returns the compiled requests' launches. Frees phase 4's programs."""
    t0 = time.perf_counter()
    total, rows = dict.fromkeys(COUNTED, 0), {}
    for path in PATHS:
        rows[path["name"]] = jit_serving_path(models, path)
    SERVED.clear()
    for path in SD_PATHS:
        rows[path["name"]] = jit_sd_path(models, path, sd)
    torch.cuda.empty_cache()
    for k, n in jit_graph_dump(models, workdir).items():
        total[k] += n
    for res in rows.values():
        for k in KERNELS:
            total[k] += res["launches"][k]
    log("jit: table " + json.dumps({n: {k: v for k, v in r.items()
                                        if k != "launches"}
                                    for n, r in rows.items()}))
    log(f"jit: {len(rows)} paths compiled == eager; launches {total}; "
        f"{time.perf_counter() - t0:.1f} s")
    return total


def phase_jit_train(models, workdir) -> dict:
    """The jit phase's training side: each training path's step and eval
    compiled against eager (``jit_train_path``), one Trainer at a time;
    returns the compiled steps' and evals' launches."""
    t0 = time.perf_counter()
    enc = {k: v[0] for k, v in passes_per_model(models).items()}
    total, rows = dict.fromkeys(COUNTED, 0), {}
    for path in TRAIN_PATHS:
        rows[path["name"]] = jit_train_path(
            path, workdir, {k: n * (path["codec"] == "vae")
                            for k, n in enc.items()})
        gc.collect()
        torch.cuda.empty_cache()
        for k in COUNTED:
            total[k] += rows[path["name"]]["launches"][k]
    log("jit: train table " + json.dumps({n: {k: v for k, v in r.items()
                                              if k != "launches"}
                                          for n, r in rows.items()}))
    log(f"jit: {len(rows)} training paths compiled == eager; launches "
        f"{total}; {time.perf_counter() - t0:.1f} s")
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
    window.check(name, {optim.KERNEL: steps,    # one group: one launch a step
                        **{k: steps * enc * vae
                           for k, enc in enc_launches.items()}},
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
                    for k in COUNTED}
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
    total = dict.fromkeys(COUNTED, 0)
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
        check_trainer_adam(path["name"], trainer)
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


@contextlib.contextmanager
def fvd_stats_spy():
    """Every ``FeatureStats`` the FVD CLI's ``make_sharded_features`` returns
    while open, as (n, sum, sum of outer products) on the host in f64."""
    seen, real = [], predict_fvd.make_sharded_features

    def make(features, layout):
        fn = real(features, layout)

        def run(v):
            st = fn(v)
            seen.append((st.n, st.raw_sum, st.raw_prod))
            return st
        return run
    predict_fvd.make_sharded_features = make
    try:
        yield seen
    finally:
        predict_fvd.make_sharded_features = real


def check_fvd_cli_eager(files, path, out, stats, window, timing,
                        compiles) -> None:
    """The FVD CLI's run again under ``disable_jit``: the same FVD and MSE,
    every batch's I3D statistics (real and generated) bit for bit, the same
    launches by body as the compiled run's (its predictor, decode and I3D
    were compiled programs); the warm batch's walls and CUDA-event spans of
    both runs (``--timing``), the compiles' seconds."""
    t0 = time.perf_counter()
    with J.disable_jit(), fvd_stats_spy() as eager_stats, \
            launch_window() as eager_w:
        eager_out, eager_lines = run_cli(path, eval_argv(files, path))
    warm_c, warm_e = timing["batches"][1], json.loads(eager_lines[-1])[
        "batches"][1]
    wall = lambda w: (w["gen_s"] + w["i3d_s"]) * 1e3
    span = warm_c["gen_span_ms"] + warm_c["i3d_span_ms"]
    log(f"jit: {path['name']} warm batch ({warm_c['clips']} clips): compiled "
        f"wall {wall(warm_c):.1f} ms (rollout and decode "
        f"{warm_c['gen_s'] * 1e3:.1f}, I3D {warm_c['i3d_s'] * 1e3:.1f}), "
        f"event span {span:.1f} ms (rollout and decode "
        f"{warm_c['gen_span_ms']:.1f}, I3D {warm_c['i3d_span_ms']:.1f}), idle "
        f"{1 - span / wall(warm_c):.1%}; eager wall {wall(warm_e):.1f} ms "
        f"(rollout and decode {warm_e['gen_s'] * 1e3:.1f}, I3D "
        f"{warm_e['i3d_s'] * 1e3:.1f}), event span "
        f"{warm_e['gen_span_ms'] + warm_e['i3d_span_ms']:.1f} ms, idle "
        f"{1 - span / wall(warm_e):.1%} against the compiled span; compiles "
        f"{sum(c['warmup_s'] + c['capture_s'] for c in compiles):.2f} s "
        f"({sorted({c['name'] for c in compiles})}); launches a batch "
        f"{ {k: n // len(timing['batches']) for k, n in window.launches.items()} }")
    same = len(stats) == len(eager_stats) and all(
        np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
        for sa, sb in zip(stats, eager_stats) for a, b in zip(sa, sb))
    counts = [(w.launches, w.bodies, w.gn_bodies) for w in (window, eager_w)]
    log(f"jit: {path['name']} (predict_fvd.main) compiled against eager: FVD "
        f"{out[0]!r} / {eager_out[0]!r}, MSE {out[1]!r} / {eager_out[1]!r}; "
        f"{len(stats)} I3D statistics (real and generated clips of each "
        f"batch) {'equal bit for bit' if same else 'DIFFER'}; launches "
        f"{counts[0][0]} compiled, {counts[1][0]} eager; the eager run "
        f"{time.perf_counter() - t0:.1f} s")
    if not (same and out == eager_out and counts[0] == counts[1]):
        raise AssertionError(f"jit: {path['name']}: compiled differs from "
                             f"eager")


def run_eval_path(models, files, path) -> dict:
    """One evaluation path at full width: finite results, exact launches by
    body, its rates from its own ``--timing`` line; the FVD CLI's compiled
    run against the same eagerly (``check_fvd_cli_eager``)."""
    name, batches = path["name"], EVAL_CLIPS // path["batch_clips"]
    t0 = time.perf_counter()
    n_compiles = len(J.COMPILES)
    with fvd_stats_spy() as stats, launch_window() as window:  # main path
        out, lines = run_cli(path, eval_argv(files, path))
    wall = time.perf_counter() - t0
    log_compiles(name, J.COMPILES[n_compiles:])
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
    if name == "fvd_native_ar4":
        if not stats or not any(c["name"] == "features"
                                for c in J.COMPILES[n_compiles:]):
            raise AssertionError(f"{name}: I3D did not run compiled")
        check_fvd_cli_eager(files, path, out, stats, window, timing,
                            J.COMPILES[n_compiles:])
    return counted(window)


def check_trainer_fvd(path, trainer, i3d):
    """``Trainer.fvd_validation`` of a training path, both protocols, over
    two seeded batches: finite FVD, wall time; each batch's program
    (``fvd_batch``, compiled) against the same eagerly: every batch's I3D
    statistics bit for bit, the FVD identical."""
    loader = [([0] * path["cfg"].batch_size, train_frames(path, seed=s))
              for s in (5, 6)]
    program = trainer._fvd_batch
    seen = []

    def spy(*args):
        out = program(*args)
        seen.append([t.cpu() for side in out for t in side[1:]])
        return out
    trainer._fvd_batch = spy
    try:
        for protocol in ("last_k", "reference"):
            runs = []
            for eager in (False, True):
                seen.clear()
                torch.cuda.synchronize()
                with (J.disable_jit() if eager else contextlib.nullcontext()
                      ), launch_window() as window:
                    t0 = time.perf_counter()
                    fvd = trainer.fvd_validation(loader, i3d, max_batches=2,
                                                 protocol=protocol)
                    ms = (time.perf_counter() - t0) * 1e3
                runs.append((fvd, list(seen), ms))
                window.check(f"{path['name']}_fvd"
                             + (" (eager)" if eager else ""),
                             {k: 0 for k in KERNELS})
            (fvd, feats, ms), (fvd_e, feats_e, ms_e) = runs
            same = len(feats) == 2 and all(
                torch.equal(a, b) for fa, fb in zip(feats, feats_e)
                for a, b in zip(fa, fb))
            log(f"{path['name']}_fvd: fvd_validation protocol {protocol}, 2 "
                f"batches of {path['cfg'].batch_size} clips x "
                f"{path['clip_frames']} frames of {path['cfg'].frame_size}px"
                f": FVD {fvd:.6f}, {ms:.1f} ms compiled (fvd_batch, "
                f"{program.n_graphs} graph(s)); eager {fvd_e:.6f}, "
                f"{ms_e:.1f} ms; the I3D statistics of both batches "
                f"{'equal bit for bit' if same else 'DIFFER'}")
            if not np.isfinite(fvd):
                raise AssertionError(f"fvd_validation {protocol}: FVD {fvd}")
            if not (same and fvd == fvd_e):
                raise AssertionError(f"jit: fvd_validation {protocol}: "
                                     f"compiled differs from eager")
    finally:
        trainer._fvd_batch = program


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
    total = dict.fromkeys(COUNTED, 0)
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
    path, the compile records of the programs it compiled, ``J.COMPILES``)."""
    argv = ["--dataset", "mnist", "--config", DATA_CONFIG, "--config_dir",
            files["dir"], "--native_cache", files["cache"], "--codec", "vae",
            "--precision", "bf16_full", "--checkpoint_dir",
            files["checkpoints"], "--debug", "True", *extra]
    native_loader.NEXT_BATCH.clear()
    multihost.COLLECTIVES.clear()
    n_compiles = len(J.COMPILES)
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
        os.path.join(files["checkpoints"], ckpt), J.COMPILES[n_compiles:]


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
    NCCL group (compiled too: its step's graph holds the gradient
    all-reduce), and the text-mode path; returns the main path's launches
    (the plain run's)."""
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
    plain, window, steps, batches, ckpt_a, programs = run_native_path(
        files, name)
    window.check(name, expected, flash_body="tf32x3")
    if (steps, batches) != (train_b, train_b + val_b):
        raise AssertionError(f"{name}: {steps} steps, {batches} batches")
    with socket.socket() as s:          # a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host, no network
    try:
        group, window2, _, _, ckpt_b, group_programs = run_native_path(
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
    names = lambda records: sorted(c["name"] for c in records)
    in_graph = {c["name"]: c["graph_collectives"] for c in group_programs}
    log(f"{name}_multihost: {backend} group of 1, compiled "
        f"({names(group_programs)}; the all-reduces each graph holds "
        f"{in_graph}): losses, parameters and moments "
        f"{'equal bit for bit' if same else 'DIFFER'} to the plain run's, "
        f"compiled ({names(programs)}); gradient all-reduces "
        f"{reduced.get('grads', 0)} for {steps} steps")
    if not same or backend != "nccl" or reduced.get("grads") != steps \
            or set(names(programs)) != {"eval_impl", "step_impl"} \
            or set(names(group_programs)) != {"eval_impl", "step_impl"} \
            or in_graph["step_impl"] != {"grads": 1}:
        raise AssertionError(f"{name}_multihost: same {same}, backend "
                             f"{backend}, collectives {reduced}, compiled "
                             f"plain {names(programs)}, group {in_graph}")
    run_text_path(files)
    log(f"data: {time.perf_counter() - t0:.1f} s")
    return counted(window)


# The tp phase (phase 11): the three multi-process entry points as four
# worker processes (this script again, ``--tp-worker``), each held against
# the same entry point in this process. By default all four share the one
# card, joined in a gloo group (NCCL refuses two ranks on one device; gloo
# stages its collectives of CUDA tensors through host memory, the port's
# ring exchange does so itself), and every program runs eagerly: the
# card's backend does not capture over gloo (``jit``'s rule), and the
# workers record their kernel signatures (``record_calls``). With
# ``--cards 4`` each worker takes a card of its own in an NCCL group, runs
# its entry point compiled (the collectives inside the graphs) and then
# the same run eagerly under ``record_calls`` (the signatures, and the
# comparison: bit for bit), and this process runs the one-process
# references compiled on card 0 (the one-card times). ``predict`` is
# ``predict_cli_denoise_ar4`` cut to 1 predicted frame refined from DDIM
# step 48 (2 UNet calls instead of 10): batches of 4 clips (the VAE mid
# block's batch of 4 splits over the 4 ranks) and of 3 clips (3 does not
# divide by 4: the 512px mid block takes the ring, 4096 / 4 = 1024 tokens
# a rank), one batch on one card, three on four (two timed after the
# compile); ``fvd`` is ``fvd_native_ar4`` over the data axis, one batch of
# 8 clips; ``train`` is ``train_flagship``'s model at published widths
# from the data phase's frame cache, f32, 2 steps at dropout 0 and 1 at
# 0.1 (the replicated parameters bit-equal across the ranks).
# Four cards add two data=4 runs of that model from the same cache:
# f32 at dropout 0, 6 clips a card, held against one process on the whole
# batch of 24; and ``train_flagship`` itself (bf16 parameters and moments,
# dropout 0.1, 6 clips a card), timed over 3 epochs of 3 steps against the
# same Trainer at 6 clips on one card (its ranks' masks differ from one
# process's, so it is held against eager and across its ranks only).
TP_WORLD = 4
TP_BACKEND = {1: "backend gloo (one card, host-staged), eager",
              4: "backend nccl (four cards), compiled"}
TP_PREDICT_PATH = dict(EVAL_PATHS[1], pred=1, refine=dict(
    EVAL_PATHS[1]["refine"], start_step=48))
# one FVD batch; 2 train steps at dropout 0, 1 at dropout 0.1
TP_FVD_CLIPS, TP_EPOCH_RATIO = 8, {0.0: 0.16, 0.1: 0.08}
TP_TIMEOUT = 420                           # seconds, a set of four workers
TP_SERVE_TIMEOUT = 240      # a four-card served run's set (it served in 61 s)
TP_RUNS = [
    dict(name="tp_predict_denoise_4", entry="predict",
         mesh="data=1,model=4", clips=4, route="batch"),
    dict(name="tp_predict_denoise_3", entry="predict",
         mesh="data=1,model=4", clips=3, route="ring"),
    dict(name="tp_fvd_native", entry="fvd", mesh="data=4"),
    dict(name="tp_train_flagship", entry="train", mesh="data=2,model=2",
         config="tp_flagship"),
    dict(name="tp_train_flagship_dropout", entry="train",
         mesh="data=2,model=2", config="tp_flagship_dropout", one=False),
    dict(name="tp_serve_rehearsal", entry="serve", mesh="data=2,model=2",
         batch=2, path=TP_PREDICT_PATH, timed=2)]
# The configs of the train runs: tp_flagship's batch of 6 (2 steps at
# dropout 0) and tp_flagship_dropout's (1 step at 0.1); on four cards
# tp_data4's 24 (3 steps at dropout 0) and flagship_data4's 24 (3 epochs of
# 3 steps, train_flagship's precision and dropout), whose one-card
# reference is flagship_one, the same at 6.
TP_CONFIGS = {
    "tp_flagship": dict(EPOCH_RATIO=[TP_EPOCH_RATIO[0.0]], DROPOUT_P=[0.0]),
    "tp_flagship_dropout": dict(EPOCH_RATIO=[TP_EPOCH_RATIO[0.1]],
                                DROPOUT_P=[0.1]),
    "tp_data4": dict(BATCH_SIZE=[24], DROPOUT_P=[0.0]),
    "flagship_data4": dict(BATCH_SIZE=[24], EPOCHS=[3]),
    "flagship_one": dict(EPOCHS=[3], EPOCH_RATIO=[0.24])}
TP_CARD_RUNS = [
    dict(name="tp_train_data4", entry="train", mesh="data=4",
         config="tp_data4", yardstick="f64"),
    dict(name="tp_serve_data4", entry="serve", mesh="data=4", batch=8,
         path=EVAL_PATHS[1], timed=4, timeout=TP_SERVE_TIMEOUT),
    dict(name="tp_serve_model4", entry="serve", mesh="data=1,model=4",
         batch=1, path=EVAL_PATHS[1], timed=4, route="ring",
         timeout=TP_SERVE_TIMEOUT),
    dict(TP_RUNS[0], clips=12, batch=4),
    dict(TP_RUNS[1], clips=9, batch=3),
    *TP_RUNS[2:5],
    dict(name="train_flagship_data4", entry="train", mesh="data=4",
         config="flagship_data4", one_config="flagship_one",
         precision="bf16_full", one=False)]
# the programs each entry point compiles at least (four cards; a train run
# compiles ``eval_impl`` too where its split has a validation batch)
TP_PROGRAMS = {"predict": {"predict_impl", "decode_impl"},
               "serve": {"predict_impl", "decode_impl"},
               "fvd": {"predict_impl", "decode_impl", "features"},
               "train": {"step_impl"}}
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
# train at data=4 (f32, 6 clips a card, 3 steps at dropout 0): held by
# in-run yardsticks, not against one process on the 24 with the bounds
# above. The split batch is not a fault: against the f64 gradient of the
# whole batch (tools/split_check.py --reference f64 on one H100 80GB HBM3
# at 700 W, 24 square clips), one process's f32 gradient reads 1.662e-5
# over all tensors, the mean of 4 slices' 1.630e-5 and the reversed
# batch's 1.662e-5; on this run's own first batch (its f64 step, the run
# rehearsed over gloo on one such card) the three read 2.714e-3, 2.713e-3
# and, for the data=4 ranks, 2.713e-3. Every product computes in f32 at
# both shapes (--products: forward within 5.7e-6 of f64); the two orders
# part where rounding moves a ReLU's or an |x|'s input across 0, by up to
# 1.1e-4 on one tensor (the data=4 run against one process on four cards).
# Step 1 (the same parameters in every run): the moments after it, worst
# tensor and all tensors at once, no farther from the f64 step's than
# TP_F64_FACTOR times one process's; its loss components no farther from
# the f64 step's than TP_F64_FACTOR times one process's, or f32's own
# floor, TP_F32_LOSS_FLOOR (a mean of f32 terms cannot be held closer than
# a few ulps). Against one process that takes the mean gradient of the 4
# slices on one card (tools/split_check.sliced_step), the same
# computation but for the all-reduce's order: every step's components
# within TP_LOSS_RTOL, the moments after step 1 within TP_MOMENT_REL_L2,
# the parameters within 2 lr a step. After steps 2-3 the split's rounding
# has parted one process's run on the whole batch and that run alike: the
# data=4 run no farther from one process than TP_F64_FACTOR times it, the
# components (or f32's floor) and the moments over all tensors at once; on
# one tensor Adam's sign-like first steps on gradients at rounding level
# let even the all-reduce's order part the two split runs as far as the
# split parts them from one process (2.4e-1 after 3 steps, rehearsed over
# gloo on one card), so the worst tensor is printed, not held, there. The
# parameters within 2 lr a step of one process's, as before. Per tensor
# the fused projections read a third at a time and a key bias's third is
# left out (its exact gradient is 0). Each rank's batch at every step is
# its rows of the one-process batch, bit for bit, and the positional term
# the timestep's.
TP_F64_FACTOR, TP_F32_LOSS_FLOOR = 2.0, 2.0 ** -21


# The served runs: the requests' clips (``serve_requests``) and the
# server's socket, in the run's directory.
SERVE_CLIPS, SERVE_SOCK = "serve.npy", "serve.sock"


def _axes(run) -> dict:
    axes = {"data": 1, "model": 1}
    axes.update({k: int(v) for k, v in (a.split("=")
                                        for a in run["mesh"].split(","))})
    return axes


def tp_argv(run, files, data_dir, one=False) -> list:
    """The entry point's command line; the mesh comes on top. ``one``: the
    one-process reference's (its own config where the run names one)."""
    if run["entry"] == "predict":
        path = dict(TP_PREDICT_PATH,
                    batch_clips=run.get("batch", TP_PREDICT_PATH[
                        "batch_clips"]))
        return eval_argv(files, path, clips=run["clips"]) + [
            "--denoise_start_step",
            str(TP_PREDICT_PATH["refine"]["start_step"])]
    if run["entry"] == "serve":
        # the batch CLI over the requests' clips (serve_requests, in the
        # run's directory); the server takes --serve on top
        path = dict(run["path"], batch_clips=run["batch"])
        return eval_argv(dict(files, mnist=os.path.abspath(SERVE_CLIPS)),
                         path, clips=1000) + [
            "--denoise_start_step", str(path["refine"]["start_step"])]
    if run["entry"] == "fvd":
        return eval_argv(files, EVAL_PATHS[0], clips=TP_FVD_CLIPS)
    config = run.get("one_config", run["config"]) if one else run["config"]
    return ["--dataset", "mnist", "--config", config, "--config_dir",
            data_dir, "--native_cache", os.path.join(data_dir, "frame_cache"),
            "--codec", "pixel", "--precision", run.get("precision", "f32"),
            "--checkpoint_dir", os.path.join(os.getcwd(), "checkpoints"),
            "--debug", "True"]


def tp_entry(run, argv, compiled=False, f64=False, slices=1):
    """Drive ``run``'s entry point in this process with spies on what it
    computes: (its return value, what the spies saw). The spies sit outside
    the compiled programs (around the predictor, the decode, the sharded
    statistics and the step's host part), so ``compiled`` runs it as a user
    would; else eagerly (``disable_jit``). A train run records each step's
    batch (digests of its rows of each data rank where it runs alone) and
    its positional term; ``f64`` adds the f64 gradient and loss of its
    first step (``f64_step``), ``slices`` trains on the mean gradient of
    that many slices of each batch (``split_check.sliced_step``)."""
    from sd_video_gen_tpu_torch.evaluation import predict_fvd as PPF
    seen = collections.defaultdict(list)
    real = (P.make_predict_fn, P.make_decode_fn, PPF.make_sharded_features,
            Trainer.fit)

    def make(*a, **kw):
        fn = real[0](*a, **kw)

        def run_(*b, **kwb):
            out = fn(*b, **kwb)
            seen["latents"].append(out[1].float().cpu())
            return out
        return run_

    def decoder(*a, **kw):
        decode = real[1](*a, **kw)

        def dec(x):
            out = decode(x)
            seen["frames"].append(out.cpu())
            return out
        return dec

    def stats(features, layout):
        fn = real[2](features, layout)

        def run_(v):
            st = fn(v)
            seen["stats"].append((st.n, st.raw_sum, st.raw_prod))
            return st
        return run_

    parts = 1 if "--mesh" in argv else _axes(run)["data"]

    def fit(self, *a, **kw):
        seen["trainer"].append(self)
        if self.state is None:            # as fit itself would
            self.init_state(seed=kw.get("seed", 0))
        seen["pe_mode"] = self.model_cfg.pe_mode
        if slices > 1:
            self._step_fn = split_check.sliced_step(
                self.model, self.codec, self.loss_w, self.cfg, slices)
        step_fn = self._step_fn

        def step(*b):
            frames = (b[1] if isinstance(b[1], torch.Tensor)
                      else torch.as_tensor(np.asarray(b[1])))
            seen["batches"].append([_digest(c)
                                    for c in frames.chunk(parts)])
            if f64 and "f64" not in seen:
                seen["f64"] = f64_step(self, frames)
            state, comps = step_fn(*b)
            if f64 and "f32_vs_step" not in seen["f64"]:
                c1 = float(np.float32(1 - Adam(1.0).b1))
                seen["f64"]["f32_vs_step"] = _distance(
                    {k: v.detach().cpu() / c1 for k, v in
                     state.opt_state["mu"].items()},
                    seen["f64"].pop("g32"))[1]
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
    P.make_predict_fn, P.make_decode_fn = make, decoder
    PPF.make_sharded_features, Trainer.fit = stats, fit
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                (contextlib.nullcontext() if compiled else J.disable_jit()):
            main = {"predict": P.main, "fvd": PPF.main, "train": T.main,
                    "serve": P.main}[run["entry"]]
            ret = main(argv)
    finally:
        P.make_predict_fn, P.make_decode_fn = real[:2]
        PPF.make_sharded_features, Trainer.fit = real[2:]
    seen["lines"] = out.getvalue().splitlines()
    return ret, seen


def f64_step(trainer, frames) -> dict:
    """The gradient and loss components of ``trainer``'s first step in
    f64: its model as it stands, cast, on ``frames`` (the codec's latents
    cast; ``tools/split_check.gradients``), on its card; the gradient on
    the host."""
    args = (trainer.codec, trainer.loss_w, trainer.cfg.frames_to_predict,
            frames)
    model = copy.deepcopy(trainer.model).double()
    grads, comps = split_check.gradients(model, *args, torch.float64)
    out = {"grads": {k: v.cpu() for k, v in grads.items()}, "comps": comps}
    del model, grads
    # the same in f32 here, outside the trainer: its distance from f64,
    # and from the trainer's first step (Adam's mu / (1 - b1))
    model = copy.deepcopy(trainer.model)
    g32 = {k: v.cpu() for k, v in split_check.gradients(model, *args)[0]
           .items()}
    out["f32_rel_l2"] = _distance(g32, out["grads"])[1]
    out["g32"] = g32
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _train_result(ret, seen) -> dict:
    """What a training run leaves to compare: the history, the saved
    (gathered) checkpoint's path, digests of this rank's own parameters."""
    (trainer,) = seen.pop("trainer")
    return dict(history=ret, steps=seen["steps"], first=seen.get("first"),
                batches=seen["batches"], pe_mode=seen["pe_mode"],
                f64=seen.get("f64"),
                checkpoint=checkpoint_path(
                    trainer.checkpoint_dir, trainer.cfg.config_name,
                    trainer.index, "test"),
                digests={k: (_digest(p), trainer.placements[k] is not None)
                         for k, p in trainer.state.params.items()})


def tp_run(run, argv, compiled=False, signatures=False, **train) -> dict:
    """``run``'s entry point in this process inside one launch window,
    compiled or eagerly, its kernel signatures recorded where asked (which
    makes every program eager): its results, seconds, launches by body,
    routes, all-reduces, compiles, train loops' walls."""
    from sd_video_gen_tpu_torch.ops.attention import TP_ROUTES
    n_compiles = len(J.COMPILES)
    J.RULED_EAGER.clear()
    t0 = time.perf_counter()
    with timed_train_loops() as walls, launch_window() as window, \
            (_kernels.record_calls() if signatures
             else contextlib.nullcontext()) as rec:
        ret, seen = tp_entry(run, argv, compiled, **train)
    res = dict(seconds=time.perf_counter() - t0, launches=window.launches,
               bodies=window.bodies, gn_bodies=window.gn_bodies,
               calls=window.calls, routes=dict(TP_ROUTES),
               collectives=dict(multihost.COLLECTIVES),
               compiles=[{k: c[k] for k in ("name", "graph_collectives",
                                            "graph_routes")}
                         for c in J.COMPILES[n_compiles:]],
               ruled_eager=dict(J.RULED_EAGER), walls=walls,
               sigs=dict(rec.calls) if signatures else {},
               lines=seen.pop("lines"))
    if run["entry"] == "train":
        res.update(_train_result(ret, seen))
    else:
        res.update(ret=ret, **seen)
    return res


def tp_worker(rank: str, world: str, port: str, job: str, out: str) -> int:
    """One rank of a tp run: joins the group (gloo on the one card, or NCCL
    on its own card of four), drives the entry point under the mesh with the
    counts at 0, and saves what it saw, its launches and the kernel
    signatures it handed the dispatchers (four cards: the compiled run, and
    the eager one under ``eager``; a served run's server, then on one card
    its batch CLI, or on four its batch CLI alone, compiled)."""
    strict_f32()
    with open(job) as f:
        run, argv, cards = json.load(f)
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                         device="cuda",
                         backend="gloo" if cards == 1 else "nccl")
    card_ = torch.device("cuda", 0 if cards == 1 else int(rank))
    if multihost.rank_device(torch.device("cuda")) != card_:
        raise AssertionError(f"rank {rank} is not on {card_}")
    # a worker that outlives its set's time prints every thread's stack
    # when its parent asks (run_tp_workers), before it is killed
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    argv = argv + ["--mesh", run["mesh"]]
    group = torch.distributed.group.WORLD
    res = dict(backend=torch.distributed.get_backend(),
               captures_over=J.BACKEND.captures_over(group))
    if run["entry"] == "serve":
        # the server until the client's shutdown; on the one card (gloo,
        # eager: no graph holds a collective) the batch CLI on the clips it
        # was sent follows in the same process
        res.update(tp_run(run, argv + ["--serve", os.path.abspath(
            SERVE_SOCK)], compiled=cards > 1, signatures=cards == 1))
        if cards == 1:
            gc.collect()
            torch.cuda.empty_cache()
            res["cli"] = tp_run(dict(run, entry="predict"), argv)
    elif cards == 1:
        res.update(tp_run(run, argv, signatures=True))
    elif run.get("reference"):
        # a served run's batch CLI: compiled, as the server runs
        res.update(tp_run(run, argv, compiled=True))
    else:
        res.update(tp_run(run, argv, compiled=True))
        gc.collect()
        torch.cuda.empty_cache()
        res["eager"] = tp_run(run, argv, signatures=True)
    torch.save(res, out)
    # NCCL's destroy waits while a graph that holds one of its collectives
    # lives. The entry points free their programs as they return
    # (multihost.releases_programs); a train run's Trainer was held here
    # (tp_entry's spy), so its programs are freed here. A sharded program
    # still alive fails the rank rather than hang it in the destroy.
    if run["entry"] == "train":
        multihost.release_programs()
    live = [o.name for o in gc.get_objects()
            if isinstance(o, J.jit) and o.groups and o.n_graphs]
    if live:
        raise AssertionError(f"rank {rank}: programs alive after the entry "
                             f"point returned: {live}")
    torch.distributed.destroy_process_group()
    return 0


def run_tp_workers(run, argv, workdir, cards, client=None):
    """``run`` as TP_WORLD worker processes on ``cards`` cards; their
    results by rank (with ``client``, called while they run: and its
    return value). A worker that fails or outlives the run's time
    (TP_TIMEOUT unless it names one) ends the phase, every worker stopped;
    one that outlives it first prints its threads' stacks to its log."""
    job = os.path.join(workdir, f"{run['name']}.json")
    with open(job, "w") as f:
        json.dump([run, argv, cards], f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(workdir, f"{run['name']}_rank{r}.pt")
            for r in range(TP_WORLD)]
    logs = [open(os.path.join(workdir, f"{run['name']}_rank{r}.log"), "w")
            for r in range(TP_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         str(TP_WORLD), str(port), job, outs[r]],
        env=dict(os.environ, LOCAL_RANK=str(r if cards > 1 else 0),
                 NCCL_SOCKET_IFNAME="lo"), stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=workdir) for r in range(TP_WORLD)]
    timeout = run.get("timeout", TP_TIMEOUT)
    end = time.monotonic() + timeout
    got, hung = None, []
    try:
        if client is not None:
            got = client(procs)
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for r in hung:
            procs[r].send_signal(signal.SIGUSR1)
        time.sleep(3.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = hung or [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(logs[bad[0]].name) as f:
            tail = f.read()[-3000:]
        what = f"outlived {timeout} s" if hung else "failed"
        raise AssertionError(f"{run['name']}: workers {bad} {what} "
                             f"({[p.returncode for p in procs]}); rank "
                             f"{bad[0]}:\n{tail}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    return ranks if client is None else (ranks, got)


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).norm() / b.norm())


def check_tp_predict(run, ranks, one, one32, expected) -> None:
    """Every rank's latents and frames against the one-process runs' in
    bf16 and f32; launches per rank exact (the ring's calls run no kernel),
    the route."""
    cat = lambda res, k: torch.cat(res[k]).float()
    keys = ("latents", "frames")
    floor = {k: _rel(cat(one, k), cat(one32, k)) for k in keys}
    for r, res in enumerate(ranks):
        got = {k: _rel(cat(res, k), cat(one32, k)) for k in keys}
        same = {k: _rel(cat(res, k), cat(one, k)) for k in keys}
        log(f"{run['name']}: rank {r}, rel L2 against one process in f32 "
            f"(one process in bf16 / this rank): predicted latents "
            f"{floor['latents']:.3e} / {got['latents']:.3e}, decoded frames "
            f"{floor['frames']:.3e} / {got['frames']:.3e} (bound "
            f"{TP_PREDICT_OVER_BF16}x the first); against one process in "
            f"bf16: {same['latents']:.3e}, {same['frames']:.3e}; routes "
            f"{res['routes']}")
        if not all(got[k] <= TP_PREDICT_OVER_BF16 * floor[k] for k in keys):
            raise AssertionError(f"{run['name']}: rank {r} disagrees")
        if res["routes"].get(run["route"], 0) == 0:
            raise AssertionError(f"{run['name']}: the {run['route']} route "
                                 f"did not run: {res['routes']}")
        want = dict(expected,
                    flash_attention=expected["flash_attention"]
                    - res["routes"].get("ring", 0))
        _check_worker_launches(run, r, res, want)


def _check_worker_launches(run, r, res, want, flash_body="wgmma"):
    """A rank's launches equal ``want`` (no Adam launch unless it says),
    its K2 launches on the NHWC body, its K1 launches on ``flash_body``."""
    want = {optim.KERNEL: 0, **want}
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
    """The replicated parameters bit-equal across the ranks (with a model
    axis, the split ones each its own); with ``one``, the losses and the
    gathered state against one process (dropout 0)."""
    digests = [res["digests"] for res in ranks]
    whole = [k for k, (_, split) in digests[0].items() if not split]
    same = all(d[k][0] == digests[0][k][0] for d in digests for k in whole)
    split = [k for k, (_, s) in digests[0].items() if s]
    model = _axes(run)["model"]
    log(f"{run['name']}: {len(whole)} replicated parameters "
        f"{'bit-equal' if same else 'DIFFER'} on all {TP_WORLD} ranks, "
        f"{len(split)} split over the model axis")
    if not same or bool(split) != (model > 1):
        raise AssertionError(f"{run['name']}: replicated parameters drift")
    if one is None:
        return
    # a step's components are each data rank's own (its rows' means):
    # their mean is the global batch's (equal rows), one per model group
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


def _distance(a: dict, b: dict) -> tuple:
    """Tensors ``a`` against ``b`` (name -> tensor): (the worst relative
    L2, its tensor) and the relative L2 over all at once; the fused input
    projections read a third at a time as well, a key bias's third left
    out (its exact gradient is 0: in every run its value is rounding
    alone, with no relative error to bound; ``tools/split_check.py``)."""
    num = den = 0.0
    for k, v in b.items():
        num += float((a[k].double() - v.double()).norm() ** 2)
        den += float(v.double().norm() ** 2)
    parts = split_check._thirds(b)
    got = split_check._thirds(a)
    worst = max((_rel(got[k], v), k) for k, v in parts.items()
                if not k.endswith("in_proj_bias[k]") and v.norm())
    return worst, (num / den) ** 0.5


def _f64_moments(grads) -> dict:
    """Adam's moments after its first step on the f64 gradient, with the
    step's own f32 factors (``train/optim.py``)."""
    adam = Adam(DATA_YML["LR"][0])
    c1, c2 = (float(np.float32(1 - b)) for b in (adam.b1, adam.b2))
    return {"mu": {k: c1 * g for k, g in grads.items()},
            "nu": {k: c2 * g * g for k, g in grads.items()}}


def check_tp_train_yardstick(run, ranks, one, split, lr) -> None:
    """The data=4 run held by its in-run yardsticks (TP_F64_FACTOR's
    comment): each rank's batches; step 1 against the f64 step beside one
    process; every step against the one-process run on the 4 slices' mean
    gradient, and its distance from one process on the whole batch against
    that run's; the parameters against both."""
    data, model = _axes(run)["data"], _axes(run)["model"]
    for r, res in enumerate(ranks):
        rows = [b[r // model] for b in one["batches"]]
        if [b[0] for b in res["batches"]] != rows or res["pe_mode"] != \
                "timestep" or one["pe_mode"] != "timestep":
            raise AssertionError(f"{run['name']}: rank {r}'s batches or "
                                 f"positional term are not one process's")
    log(f"{run['name']}: every rank's batch at each of "
        f"{len(one['batches'])} steps is its rows of the one-process batch "
        f"bit for bit; positional term {one['pe_mode']} on every rank")
    by_data = [res["steps"] for res in ranks[::model]]
    got = [{k: sum(d[i][k] for d in by_data) / len(by_data) for k in w}
           for i, w in enumerate(one["steps"][:len(by_data[0])])]
    exact = one["f64"]
    steps = len(split["steps"])
    fmt = lambda d: f"{d[0][0]:.3e} ({d[0][1]}) / {d[1]:.3e}"
    ok = len(got) == steps == len(one["steps"])

    def comps_rel(a, b):
        return {k: abs(a[k] - b[k]) / abs(b[k]) for k in b if b[k]}
    # step 1, the same parameters in every run: against the f64 step
    f64 = _f64_moments(exact["grads"])
    d4, d1, ds = ({t: _distance(res["first"][t], f64[t])
                   for t in ("mu", "nu")} for res in (ranks[0], one, split))
    c4, c1 = (comps_rel(c, exact["comps"]) for c in (got[0],
                                                     one["steps"][0]))
    log(f"{run['name']}: step 1 against the f64 step (worst tensor / all "
        f"tensors; the f32 step of one process on the whole batch in this "
        f"process reads {exact['f32_rel_l2']:.3e} over all tensors from "
        f"it and {exact['f32_vs_step']:.3e} from the trainer's): "
        + "; ".join(f"{t} data={data} {fmt(d4[t])}, one process "
                    f"{fmt(d1[t])}, the slices' mean {fmt(ds[t])}"
                    for t in ("mu", "nu"))
        + f" (bound {TP_F64_FACTOR}x one process's); loss components "
        f"{ {k: '%.2e / %.2e' % (c4[k], c1[k]) for k in c1} } (bound "
        f"{TP_F64_FACTOR}x one process's or {TP_F32_LOSS_FLOOR:.2e})")
    ok = ok and all(d4[t][0][0] <= TP_F64_FACTOR * d1[t][0][0]
                    and d4[t][1] <= TP_F64_FACTOR * d1[t][1] for t in d4)
    ok = ok and all(c4[k] <= max(TP_F64_FACTOR * c1[k], TP_F32_LOSS_FLOOR)
                    for k in c1)
    # every step: against the one-process run on the slices' mean gradient
    same = [max(comps_rel(g, w).values())
            for g, w in zip(got, split["steps"])]
    first = {t: _distance(ranks[0]["first"][t], split["first"][t])
             for t in ("mu", "nu")}
    tp_state, split_state = _states(ranks[0]["checkpoint"],
                                    split["checkpoint"])
    _, one_state = _states(ranks[0]["checkpoint"], one["checkpoint"])
    last = {t: _distance(tp_state[t], split_state[t]) for t in ("mu", "nu")}
    apart = lambda b: max(float((tp_state["params"][k] - v).abs().max())
                          for k, v in b["params"].items())
    params, params_one = apart(split_state), apart(one_state)
    log(f"{run['name']}: against one process on the {data} slices' mean "
        f"gradient: loss components worst rel diff "
        f"{['%.2e' % x for x in same]} (rtol {TP_LOSS_RTOL}); after step 1 "
        f"mu {fmt(first['mu'])}, nu {fmt(first['nu'])} (worst bound "
        f"{TP_MOMENT_REL_L2}); after step {steps} mu {fmt(last['mu'])}, nu "
        f"{fmt(last['nu'])}; parameters worst |diff| {params:.3e}, against "
        f"one process on the whole batch {params_one:.3e} (bound "
        f"{2 * lr * steps:.1e} each)")
    ok = ok and (tp_state["step"] == split_state["step"] == steps
                 and max(same) <= TP_LOSS_RTOL
                 and max(first[t][0][0] for t in first) <= TP_MOMENT_REL_L2
                 and max(params, params_one) <= 2 * lr * steps * 1.001)
    # steps 2-3: the split's rounding parts one process's run and the
    # slices' mean run alike; the data=4 run no farther from one process
    far4 = [comps_rel(g, w) for g, w in zip(got, one["steps"])]
    fars = [comps_rel(g, w) for g, w in zip(split["steps"], one["steps"])]
    l4, ls = ({t: _distance(st[t], one_state[t]) for t in ("mu", "nu")}
              for st in (tp_state, split_state))
    log(f"{run['name']}: against one process on the whole batch, data="
        f"{data} / the slices' mean: loss components "
        + ", ".join(f"step {i + 1} "
                    f"{max(a.values()):.2e} / {max(b.values()):.2e}"
                    for i, (a, b) in enumerate(zip(far4, fars)))
        + f"; after step {steps} mu {fmt(l4['mu'])} / {fmt(ls['mu'])}, nu "
        f"{fmt(l4['nu'])} / {fmt(ls['nu'])} (bound {TP_F64_FACTOR}x the "
        f"second over all tensors, or f32's floor for a component)")
    ok = ok and all(a[k] <= max(TP_F64_FACTOR * b[k], TP_F32_LOSS_FLOOR)
                    for a, b in zip(far4[1:], fars[1:]) for k in b)
    ok = ok and all(l4[t][1] <= TP_F64_FACTOR * ls[t][1] for t in l4)
    if not ok:
        raise AssertionError(f"{run['name']}: outside its yardsticks")


def write_test_clips(path: str, clips: np.ndarray, seed: int = 0) -> None:
    """Write a Moving-MNIST-layout ``.npy`` whose test split, read at
    ``seed`` (the CLIs' ``--seed``, 0 by default), yields exactly ``clips``
    ((N, T, H, W) uint8) in this order: the clips a client sends a server,
    for the batch CLI. Its train split repeats the first clip."""
    n = len(clips)
    total = n
    while total - int(total * 0.8) != n:
        total += 1
    test = np.empty_like(clips)
    test[np.random.default_rng(seed).permutation(n)] = clips
    raw = np.concatenate([np.repeat(clips[:1], total - n, axis=0), test])
    np.save(path, np.ascontiguousarray(np.transpose(raw, (1, 0, 2, 3))))


def serve_requests(run, files) -> list:
    """A served run's requests: a warm one and ``run["timed"]`` more,
    ``run["batch"]`` clips each from the evaluation clips' test split (the
    second timed one a clip short, where the batch holds more than one),
    uint8 (clips, T, H, W, 3); the clips padded as the server pads them
    written to SERVE_CLIPS, which the batch CLI reads back in this order."""
    data = MovingMNISTDataset(CONTEXT, 1, files["mnist"], "test",
                              seed=0).data
    batch, out, padded, at = run["batch"], [], [], 0
    for i in range(1 + run["timed"]):
        n = batch - 1 if i == 2 and batch > 1 else batch
        rows = [(at + j) % len(data) for j in range(n)]
        at += n
        out.append(np.ascontiguousarray(data[rows]))
        padded += rows + [rows[-1]] * (batch - n)
    write_test_clips(os.path.abspath(SERVE_CLIPS), data[padded][..., 0])
    return out


def serve_client(requests, timeout_s):
    """The client of a served run, called while its workers run: it waits
    for the socket (failing at once if a rank ends first), sends
    ``requests`` and an oversize one (an error reply), then ``shutdown``;
    returns the replies with their latencies (the server's and this
    side's)."""
    def client(procs):
        sock = os.path.abspath(SERVE_SOCK)
        t0 = time.perf_counter()
        while True:
            if any(p.poll() is not None for p in procs):
                raise AssertionError(f"serve: ranks ended before "
                                     f"SERVE_READY: "
                                     f"{[p.poll() for p in procs]}")
            try:
                S.ping(sock, timeout_s=5.0)
                break
            except OSError:
                if time.perf_counter() - t0 > timeout_s:
                    raise
                time.sleep(0.5)
        out = {"wait_s": time.perf_counter() - t0, "replies": []}
        for frames in requests:
            t1 = time.perf_counter()
            imgs, is_pred, head = S.request(sock, frames,
                                            timeout_s=timeout_s)
            out["replies"].append(dict(
                imgs=imgs, is_pred=is_pred, latency_s=head["latency_s"],
                wall_s=time.perf_counter() - t1))
        try:
            S.request(sock, np.concatenate([requests[0]] * 2)[
                :len(requests[0]) + 1])
            out["oversize"] = None
        except RuntimeError as e:
            out["oversize"] = str(e)
        out["shutdown"] = S.shutdown(sock)
        return out
    return client


def check_tp_serve(run, ranks, client, one, one32, models, cards) -> dict:
    """A served run: every reply bit-equal to the same mesh's batch CLI
    on its clips (model rank 0 of each data rank's rows, in order), within
    TP_PREDICT_OVER_BF16 of one process (replies and the mesh CLI's
    latents, against the f32 run, as the bf16 run stands from it); exact
    launches a rank by body in both, the route where the run names one,
    compiled programs over NCCL on four cards; returns the row of its
    rates."""
    axes, batch = _axes(run), run["batch"]
    path = dict(run["path"], batch_clips=batch)
    replies = client["replies"]
    n = [len(r["imgs"]) for r in replies]
    pred = [False] * (CONTEXT - 1) + [True] * path["pred"]
    holders = [ranks[d * axes["model"]]["cli"] for d in range(axes["data"])]

    def rows(res_list, key, i):
        """Batch ``i`` of ``key`` over the ranks of ``res_list``, its first
        n[i] clips."""
        x = torch.cat([res[key][i] for res in res_list]).float().numpy()
        return x.reshape(batch, -1, *x.shape[1:])[:n[i]]
    equal = all(np.array_equal(r["imgs"], rows(holders, "frames", i)
                               .astype(np.uint8))
                for i, r in enumerate(replies))
    if (not equal or any(r["is_pred"] != pred for r in replies)
            or "exceeds the compiled" not in (client["oversize"] or "")
            or not client["shutdown"].get("ok")):
        raise AssertionError(f"{run['name']}: replies bit-equal to the "
                             f"mesh's batch CLI: {equal}; is_pred, the "
                             f"oversize reply {client['oversize']!r}, "
                             f"shutdown {client['shutdown']}")
    cat = lambda src, key: np.concatenate([rows(src, key, i)
                                           for i in range(len(n))])
    got = {"frames": np.concatenate([r["imgs"] for r in replies]),
           "latents": cat(holders, "latents")}
    floor = {k: _rel(cat([one], k), cat([one32], k)) for k in got}
    far = {k: _rel(got[k], cat([one32], k)) for k in got}
    log(f"{run['name']}: {len(replies)} replies ({n} clips) bit-equal to "
        f"the batch CLI under --mesh {run['mesh']}; rel L2 against one "
        f"process in f32 (one process in bf16 / the replies, the mesh CLI's "
        f"latents): frames {floor['frames']:.3e} / {far['frames']:.3e}, "
        f"latents {floor['latents']:.3e} / {far['latents']:.3e} (bound "
        f"{TP_PREDICT_OVER_BF16}x the first); oversize request: "
        f"{client['oversize']!r}")
    if not all(far[k] <= TP_PREDICT_OVER_BF16 * floor[k] for k in far):
        raise AssertionError(f"{run['name']}: the replies disagree with "
                             f"one process")
    for r, res in enumerate(ranks):
        for part, batches in ((res, 1 + len(replies)),
                              (res["cli"], len(replies))):
            expected = expected_launches(models, path, batches)
            want = dict(expected, flash_attention=expected[
                "flash_attention"] - part["routes"].get("ring", 0))
            _check_worker_launches(run, r, part, want)
            names = {c["name"] for c in part["compiles"]}
            if cards > 1 and (not TP_PROGRAMS["serve"] <= names
                              or part["ruled_eager"]
                              or not res["captures_over"]):
                raise AssertionError(f"{run['name']}: rank {r} compiled "
                                     f"{sorted(names)}, eager by the rule "
                                     f"{part['ruled_eager']}")
        if run.get("route") and not res["routes"].get(run["route"]):
            raise AssertionError(f"{run['name']}: the {run['route']} route "
                                 f"did not run: {res['routes']}")
    ready = [json.loads(x.split(" ", 1)[1]) for x in ranks[0]["lines"]
             if x.startswith("SERVE_READY ")]
    timed = replies[1:]
    frames = sum(len(r["imgs"]) * path["pred"] for r in timed)
    secs = sum(r["latency_s"] for r in timed)
    row = {"ready_s": ready[0]["ready_s"] if ready else None,
           "latency_s": [r["latency_s"] for r in replies],
           "client_s": [round(r["wall_s"], 4) for r in replies],
           "steady_fps": round(frames / secs, 4),
           "launches_a_rank": {k: ranks[0]["launches"][k]
                               + ranks[0]["cli"]["launches"][k]
                               for k in KERNELS},
           "bodies_a_rank": dict(ranks[0]["bodies"]),
           "gn_bodies_a_rank": dict(ranks[0]["gn_bodies"]),
           "routes_a_rank": [res["routes"] for res in ranks]}
    log(f"{run['name']}: ready_s {row['ready_s']}, request latencies "
        f"{row['latency_s']} s (the first warm), steady {row['steady_fps']} "
        f"frames/s ({frames} frames in {secs:.4f} s), launches a rank "
        f"{row['launches_a_rank']} (server: bodies {row['bodies_a_rank']}, "
        f"{row['gn_bodies_a_rank']}), routes a rank {row['routes_a_rank']}")
    return row


def _same_run(run, a, b) -> bool:
    """A rank's compiled run against its eager one, bit for bit: what the
    entry point returned and what the spies saw."""
    eq = lambda x, y: (torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                       if isinstance(x, (torch.Tensor, np.ndarray))
                       else x == y)
    if run["entry"] == "train":
        return a["steps"] == b["steps"] and a["digests"] == b["digests"]
    keys = ("latents", "frames") + (("stats",) if run["entry"] == "fvd"
                                    else ())
    return (all(len(a[k]) == len(b[k]) and all(
        all(map(eq, x, y)) if isinstance(x, tuple) else eq(x, y)
        for x, y in zip(a[k], b[k])) for k in keys)
        and (run["entry"] != "fvd" or a["ret"] == b["ret"]))


def check_tp_compiled(run, ranks) -> None:
    """Four cards: every rank compiled its entry point's programs (none
    eager by the backend's rule), its collectives inside the step's graph;
    its compiled run equals its eager run bit for bit, with equal launches,
    routes and all-reduces."""
    want = TP_PROGRAMS[run["entry"]]
    for r, res in enumerate(ranks):
        eager = res["eager"]
        names = {c["name"] for c in res["compiles"]}
        steps = [c["graph_collectives"] for c in res["compiles"]
                 if c["name"] == "step_impl"]
        grads = {"grads": 1} if _axes(run)["data"] > 1 else {}
        same = _same_run(run, res, eager)
        if run["entry"] == "train" and r == 0:
            compiled_state, eager_state = _states(res["checkpoint"],
                                                  eager["checkpoint"])
            same = same and all(torch.equal(v, eager_state[t][k])
                                for t in ("params", "mu", "nu")
                                for k, v in compiled_state[t].items())
        log(f"{run['name']}: rank {r} compiled {sorted(names)} (the step's "
            f"graph all-reduces {steps}), against its eager run: "
            f"{'equal bit for bit' if same else 'DIFFERENT'}; launches "
            f"{res['launches']} / {eager['launches']}, routes "
            f"{res['routes']} / {eager['routes']}, all-reduces "
            f"{res['collectives']} / {eager['collectives']}")
        if (res["backend"] != "nccl" or not res["captures_over"]
                or not want <= names or res["ruled_eager"]
                or eager["compiles"] or not same
                or any(s != grads for s in steps)
                or res["launches"] != eager["launches"]
                or res["routes"] != eager["routes"]
                or res["collectives"] != eager["collectives"]):
            raise AssertionError(
                f"{run['name']}: rank {r}: backend {res['backend']}, "
                f"compiled {sorted(names)} (at least {sorted(want)}), eager "
                f"by the rule {res['ruled_eager']}, the eager run compiled "
                f"{eager['compiles']}, equal {same}, the step's graph "
                f"all-reduces {steps} (want {grads} each)")


def _rates(run, res):
    """The run's warm rate, where its entry point gives one: predicted
    frames a second after the first batch (the predict CLI's timing line),
    or optimizer steps a second over the epochs after the first (else
    after the first step); None where there is no such window (one batch,
    one step, the FVD CLI) or where it holds a compile (a compiled predict
    run compiles its decode after the first batch's rollout)."""
    if run["entry"] == "predict":
        timing = [json.loads(x) for x in res["lines"]
                  if x.startswith("{") and '"stage_s"' in x]
        if not timing:
            raise AssertionError(f"{run['name']}: no timing line")
        (t,) = timing
        frames = (t["clips"] - run.get("batch", t["clips"])) * t[
            "pred_frames_per_clip"]
        warm = t["total_s"] - t["first_sync_s"]
        if not frames or res["compiles"]:
            return None
        return f"{frames / warm:.4f} frames/s warm ({frames} frames in " \
               f"{warm:.3f} s)"
    if run["entry"] == "train":
        walls = res["walls"]
        if len(walls) > 1:
            steps = sum(w[1] for w in walls[1:])
            secs = sum(w[0] for w in walls[1:])
        else:
            (_, n, secs), = walls
            steps = n - 1
        return (f"{steps / secs:.4f} steps/s ({steps} steps in {secs:.3f} s)"
                if steps else None)
    return None


def phase_tp(models, files, data_dir, workdir, cards=1, runs=None) -> tuple:
    """The tp runs (``runs``, by default all of the mode's), each against
    its one-process run; every per-rank kernel signature against the plain
    version; returns the workers' launches and a table of each run's
    times."""
    t0 = time.perf_counter()
    for name, extra in TP_CONFIGS.items():
        write_config(os.path.join(data_dir, name + ".yml"),
                     dict(DATA_YML, **extra))
    total = dict.fromkeys(COUNTED, 0)
    sigs = collections.Counter()
    table = {}
    for run in runs or (TP_RUNS if cards == 1 else TP_CARD_RUNS):
        d = os.path.join(workdir, run["name"])
        os.makedirs(d)
        serving = run["entry"] == "serve"
        with contextlib.chdir(d):
            requests = serve_requests(run, files) if serving else None
            argv = tp_argv(run, files, data_dir)
            # a served run's references: the batch CLI on its clips
            ref = dict(run, entry="predict") if serving else run
            one = one32 = split = None
            if run["entry"] in ("predict", "serve"):
                with launch_window():
                    one32 = tp_entry(ref, argv + ["--denoise_precision",
                                                  "f32"])[1]
            if run.get("one", True) or "one_config" in run:
                one = tp_run(ref, tp_argv(run, files, data_dir, one=True),
                             compiled=cards > 1,
                             f64=run.get("yardstick") == "f64")
                gc.collect()
                torch.cuda.empty_cache()
            if run.get("yardstick"):
                split = tp_run(run, tp_argv(run, files, data_dir, one=True),
                               compiled=cards > 1,
                               slices=_axes(run)["data"])
                gc.collect()
                torch.cuda.empty_cache()
            client = None
            if serving:
                ranks, client = run_tp_workers(
                    run, argv, d, cards, serve_client(
                        requests, run.get("timeout", TP_TIMEOUT)))
                # four cards: the batch CLI under the same mesh on the
                # same clips in processes of its own (tp_worker)
                if cards > 1:
                    cli = run_tp_workers(dict(
                        ref, name=run["name"] + "_cli", reference=True),
                        argv, d, cards)
                    for res, c in zip(ranks, cli):
                        res["cli"] = c
            else:
                ranks = run_tp_workers(run, argv, d, cards)
        worst = lambda key: max(r[key]["seconds"] if key else r["seconds"]
                                for r in ranks)
        row = {"mesh": run["mesh"], "cards": cards,
               "rank_s": round(worst(None), 3),
               "rate": _rates(run, ranks[0])}
        if serving:
            row.update(check_tp_serve(run, ranks, client, one, one32,
                                      models, cards))
        elif cards > 1:
            row.update(eager_rank_s=round(worst("eager"), 3),
                       eager_rate=_rates(run, ranks[0]["eager"]))
        if one is not None:
            row.update(one_s=round(one["seconds"], 3),
                       one_rate=_rates(run, one))
        table[run["name"]] = row
        log(f"{run['name']}: --mesh {run['mesh']}, {TP_WORLD} ranks on "
            f"{cards} card(s), {TP_BACKEND[cards]}: {row}")
        if any(r["backend"] != ("gloo" if cards == 1 else "nccl")
               for r in ranks):
            raise AssertionError(f"{run['name']}: not the group asked for")
        if cards == 1:
            # the card's backend does not capture over gloo: no graph
            if any(r["captures_over"] or r["compiles"] for r in ranks):
                raise AssertionError(f"{run['name']}: a gloo worker "
                                     f"compiled a program")
        elif not serving:
            check_tp_compiled(run, ranks)
        checked = one if run.get("one", True) else None
        if serving:
            pass                           # check_tp_serve, above
        elif run["entry"] == "predict":
            batches = -(-run["clips"] // run.get("batch", TP_PREDICT_PATH[
                "batch_clips"]))
            expected = expected_launches(models, TP_PREDICT_PATH, batches)
            check_tp_predict(run, ranks, checked, one32, expected)
        elif run["entry"] == "fvd":
            # each rank runs every pass of the path on its slice
            check_tp_fvd(run, ranks, checked,
                         expected_launches(models, EVAL_PATHS[0],
                                           TP_FVD_CLIPS // EVAL_PATHS[0][
                                               "batch_clips"]))
        elif run.get("yardstick"):
            check_tp_train_yardstick(run, ranks, one, split,
                                     DATA_YML["LR"][0])
        else:
            check_tp_train(run, ranks, checked, DATA_YML["LR"][0])
        if run["entry"] == "train":
            # the transformer reaches neither K1 nor K2; one group: one
            # Adam launch a step on every rank
            for r, res in enumerate(ranks):
                _check_worker_launches(run, r, res, {
                    **dict.fromkeys(KERNELS, 0),
                    optim.KERNEL: len(res["steps"])})
        if run["entry"] == "train":
            # the f32 flagship's whole states (5.3 GB each) leave the disk
            for res in [ranks[0], ranks[0].get("eager"), one, split]:
                if res is not None:
                    shutil.rmtree(res["checkpoint"])
        for res in ranks:
            sigs.update(res.get("eager", res)["sigs"])
            for part in (res, res.get("cli")):
                if part is None:
                    continue
                BODY_LAUNCHES.update(part["bodies"])
                for k in COUNTED:
                    total[k] += part["launches"][k]
    # every rank path that reaches a kernel runs it in bf16 on the NHWC
    # body; f32 and the NCHW body are checked at every full-width shape in
    # phase 3, and are left out here, and these rows are not timed (the
    # script's time bound)
    rows = check_signatures(sigs, (torch.bfloat16,), what="tp per-rank: ",
                            nchw=False, timing=False)
    log(f"tp: {len(rows)} kernel rows at the per-rank shapes agree; "
        f"launches of the {TP_WORLD}-rank runs {total}; "
        f"{time.perf_counter() - t0:.1f} s ({TP_BACKEND[cards]})")
    return total, table


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
    """A child's COUNTED line: launches equal ``expected`` for each kernel
    it names, every dispatcher call a launch, every flash launch on the
    ``wgmma`` body and every GroupNorm launch on the ``nhwc`` body. Returns
    its launches, the flash ones by body added to ``BODY_LAUNCHES``."""
    launches, bodies = counts["launches"], counts["bodies"]
    log(f"{name}: launches {launches}; by body {bodies}; dispatcher calls "
        f"{counts['calls']}; the path implies {expected}")
    nonzero = lambda d: {k: n for k, n in d.items() if n}
    if any(launches[k] != n for k, n in expected.items()) \
            or counts["calls"] != nonzero(launches):
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
    total = dict.fromkeys(COUNTED, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    def times(n):          # a serving child runs no optimizer
        return {optim.KERNEL: 0, **{k: n * v for k, v in per_batch.items()}}

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
# one scenario of each kind (pixel serving, denoised serving, training):
# phases 4, 7 and 8 drive every path of the other seven, with exact launches
BENCH_SCENARIOS = ("pixel_ar16", "vae_denoise_ar4_8streams",
                   "train_flagship")


def phase_bench() -> dict:
    """The benchmark's BENCH_SCENARIOS in this process; a scenario that
    fails fails the run. Returns their launches (every window of both
    passes), the flash ones by body added to ``BODY_LAUNCHES``."""
    from sd_video_gen_tpu_torch import bench
    t0 = time.perf_counter()
    results = {}
    failed = bench.run([n for n in bench.select([]) if n in BENCH_SCENARIOS],
                       repeats=BENCH_REPEATS, results=results)
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
        f"GroupNorm {launches['groupnorm_silu']}, Adam "
        f"{launches[optim.KERNEL]}")


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
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4),
                        help="4: only the device, build and tp phases, the "
                             "tp workers on four cards over NCCL, compiled")
    parser.add_argument("--runs", type=lambda v: v.split(","),
                        help="with --cards 4: only these tp runs, by name "
                             "(comma-separated)")
    parser.add_argument("--tp-worker", nargs=5, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.tp_worker:
        return tp_worker(*args.tp_worker)
    strict_f32()
    if args.cards > 1:
        return main_cards(args.cards, args.runs)
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
            launches = dict.fromkeys(COUNTED, 0)
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
            gc.collect()
            torch.cuda.empty_cache()
            for k, n in phase_jit_train(models, workdir).items():
                launches[k] += n
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
            tp_launches, _ = phase_tp(models, files, data_dir, tp_dir)
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
            for k in COUNTED:
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
         **summary[k]} for k in KERNELS] + [
        {"name": optim.KERNEL, "route": "cuda",
         "source": "sd_video_gen_tpu_torch/csrc/adam.cu", "replaces": None,
         "launches": launches[optim.KERNEL], **summary[optim.KERNEL],
         "checks": ADAM_ROWS}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_cards(cards: int, names=None) -> int:
    """``--cards 4``: the device, build and tp phases, the tp runs over
    NCCL on four cards (the files they read made as the default run makes
    them; ``names``: only those runs, and the models and files only where
    a predict or FVD run reads them); the runs' times as JSON on the line
    before the last."""
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: --cards {cards} needs {cards} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    runs = [r for r in TP_CARD_RUNS if names is None or r["name"] in names]
    if names is not None and len(runs) != len(set(names)):
        print(f"chip_smoke: --runs: not all of {sorted(names)} are among "
              f"{[r['name'] for r in TP_CARD_RUNS]}", file=sys.stderr)
        return 1
    evals = any(r["entry"] != "train" for r in runs)
    t0 = time.perf_counter()
    phase_device()
    with tempfile.TemporaryDirectory(prefix="sdvg") as workdir:
        eval_dir = os.path.join(workdir, "eval")
        os.makedirs(eval_dir)
        sd_files = start_sd_weight_files(eval_dir) if evals else None
        try:
            phase_build()
            models = files = None
            if evals:
                models = mode_models(full_width_models(), FLAGSHIP)
                files = eval_files(models, eval_dir)
            data_dir = os.path.join(workdir, "data")
            os.makedirs(data_dir)
            build_caches(data_files(data_dir))
            if evals and sd_files.wait(timeout=600) != 0:
                raise RuntimeError(f"the SD weight files were not written: "
                                   f"exit {sd_files.returncode}")
            tp_dir = os.path.join(workdir, "tp")
            os.makedirs(tp_dir)
            log(f"phase tp: starts at {time.perf_counter() - t0:.1f} s")
            launches, table = phase_tp(models, files, data_dir, tp_dir,
                                       cards, runs)
        finally:
            if sd_files is not None and sd_files.poll() is None:
                sd_files.kill()
                sd_files.wait()
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"cards": cards, "launches": launches, "runs": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
