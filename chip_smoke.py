"""Drive the PyTorch port (``sd_video_gen_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; there is no CPU path):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the CUDA kernel from csrc/ with nvcc, timed
  3. kernel   flash attention against its plain PyTorch version at every shape
              the denoised AR path gives it, bf16 and f32, timed with CUDA
              events (plain, kernel, kernel, plain)
  4. slice    the full-width denoised AR serving path (flagship
              FrameTransformer + SD-v1.4 VAE/UNet/CLIP-text, bf16, seeded
              random weights): the port's ``serve`` loop answers predict
              requests over a Unix socket; reply shapes, finite latents and
              the exact kernel launch count are checked, warm frames/sec
              printed
  5. check    one full-width 512px UNet forward with the kernel against the
              same forward with plain attention (relative L2), and the whole
              slice at small widths in f32 on the card (kernel) against the
              CPU (plain attention) with the same weights and noise

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. TF32 is switched off for cuDNN and matmul
so every f32 comparison runs in full f32.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                     CLIPTextEncoder)
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops.attention import (flash_attention,
                                                  force_reference,
                                                  reference_attention)
from sd_video_gen_tpu_torch.predict import serve as S
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn

FRAME, CONTEXT, PRED, HI_RES, START_STEP, DDIM_STEPS = 64, 5, 4, 512, 40, 50
REQUESTS = 3
# (BH, T, d) of every flash-attention call on the path at B=1: UNet levels
# 0-2 and mid at 512px; VAE mid block at 512px and at 64px (5 context frames)
PATH_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160), (8, 64, 160),
               (1, 4096, 512), (5, 64, 512)]
# f32: FMA order over up to 4096 keys. bf16: p is rounded to bf16 before p.v
# and the output to bf16, as in the TPU kernel.
KERNEL_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 UNet, kernel vs plain attention: both round p and each output to bf16
# but sum in other orders; one-ulp differences (2^-8 relative) pass through
# 16 attention layers and the residual stream.
UNET_REL_L2 = 2e-2
# f32 slice at small widths, card vs CPU: summation order only (TF32 off),
# but frames pass through uint8 twice per refine, so a value on a rounding
# boundary may flip a level and move the re-encoded latent.
SMALL_LATENT_ATOL = 1e-3
SMALL_PIXEL_FLIP_SHARE = 0.01
UNET_ATTN_PER_FORWARD = 16   # self-attention: 6 down, 1 mid, 9 up


def log(*a):
    print(*a, flush=True)


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


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    _kernels.library()
    log(f"build: {_kernels.BUILD['path']} nvcc {_kernels.BUILD['seconds']:.2f} s"
        f" (load included {time.perf_counter() - t0:.2f} s)")


def phase_kernel() -> dict:
    dev = torch.device("cuda")
    rows, failures = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in PATH_SHAPES:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            scale = shape[-1] ** -0.5
            out = flash_attention(q, k, v, scale)
            ref = reference_attention(q.float(), k.float(), v.float(), scale)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            iters = 20 if shape[1] >= 1024 else 100
            plain = lambda: reference_attention(q, k, v, scale)
            kern = lambda: flash_attention(q, k, v, scale)
            p1, k1, k2, p2 = (cuda_ms(f, iters)
                              for f in (plain, kern, kern, plain))
            row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                       max_abs_err=err, atol=KERNEL_ATOL[dtype],
                       ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
            rows.append(row)
            log("kernel: " + json.dumps(row))
            if not err <= KERNEL_ATOL[dtype]:
                failures.append(row)
    if failures:
        raise AssertionError(f"flash_attention disagrees with the plain "
                             f"version: {failures}")
    # the summary's times are those of the shape with the most device time
    # on the path (UNet level 0); its error is the worst over all rows
    hot = next(r for r in rows
               if r["shape"] == [8, 4096, 40] and r["dtype"] == "bfloat16")
    log(f"kernel: summary times at {hot['shape']} {hot['dtype']}")
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=hot["ms"], plain_ms=hot["plain_ms"])


def _assert_finite(name, x):
    if not torch.isfinite(x).all():
        raise AssertionError(f"{name}: non-finite values")
    return x


def checked_refine(refine):
    """The refiner, failing on a non-finite latent in or out."""
    def run(flat, step):
        _assert_finite(f"predicted latent (step {step})", flat)
        return _assert_finite(f"refined latent (step {step})",
                              refine(flat, step))
    return run


def checked_predict(predict):
    """The predict entry point, failing on non-finite latents."""
    def run(frames):
        context, preds = predict(frames)
        return _assert_finite("context", context), _assert_finite("preds",
                                                                  preds)
    return run


def _models(device, dtype, vae_cfg, unet_cfg, clip_cfg, ft_dims, frame):
    """VAE, UNet, CLIP-text and FrameTransformer, seeded, built on device."""
    vae = build(AutoencoderKL, vae_cfg, device, dtype, seed=0)
    latent_dim = VAECodec(frame, vae).latent_dim
    return (vae, build(UNet2DCondition, unet_cfg, device, dtype, seed=1),
            build(CLIPTextEncoder, clip_cfg, device, dtype, seed=2),
            build(FrameTransformer, FrameTransformerConfig(
                latent_dim=latent_dim, **ft_dims), device, dtype, seed=3))


def _predict_fn(models, frame, hi_res, pred, noise_fn=None, checked=False):
    """The port's predict entry point over ``models`` (refine at hi_res)."""
    vae, unet, clip, ft = models
    codec = VAECodec(frame, vae)
    refine = make_denoise_refiner(SDPipeline(vae, unet, clip), frame,
                                  START_STEP, DDIM_STEPS, hi_res, noise_fn)
    if checked:
        refine = checked_refine(refine)
    predict = make_predict_fn(ft, codec, pred, window=CONTEXT, refiner=refine)
    return codec, checked_predict(predict) if checked else predict


def phase_slice() -> dict:
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t0 = time.perf_counter()
    models = _models(dev, bf16, VAEConfig(), UNetConfig(), CLIPTextConfig(),
                     dict(dim_model=2048, num_heads=8, num_encoder_layers=4,
                          num_decoder_layers=8), FRAME)
    n_params = sum(p.numel() for m in models for p in m.parameters())
    torch.cuda.synchronize()
    log(f"slice: built {n_params / 1e6:.1f}M params bf16 on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    codec, predict = _predict_fn(models, FRAME, HI_RES, PRED, checked=True)

    sock_dir = tempfile.TemporaryDirectory(prefix="sdvg")
    sock = os.path.join(sock_dir.name, "serve.sock")
    if len(sock) > 100:
        raise RuntimeError(f"socket path too long for AF_UNIX: {sock}")
    errors = []

    def run_server():
        try:
            S.serve(sock, predict, codec.decode_latents, batch_clips=1,
                    frames_per_clip=CONTEXT, frame_size=FRAME)
        except Exception as e:  # re-raised by the main thread below
            errors.append(e)

    _kernels.LAUNCHES.clear()                     # main path starts here
    t_start = time.perf_counter()
    server = threading.Thread(target=run_server, daemon=True)
    server.start()
    replies = []
    try:
        while True:  # the warm-up batch runs before the socket exists
            if errors or not server.is_alive():
                raise RuntimeError(f"serve loop stopped before it was "
                                   f"ready: {errors}")
            try:
                S.ping(sock)
                break
            except OSError:
                time.sleep(0.5)
        ready_s = time.perf_counter() - t_start
        log(f"slice: server ready after {ready_s:.1f} s (warm-up batch "
            f"included)")
        rng = np.random.default_rng(0)
        for i in range(REQUESTS):
            frames = rng.integers(0, 256, (1, CONTEXT, FRAME, FRAME, 3),
                                  dtype=np.uint8)
            t1 = time.perf_counter()
            imgs, is_pred, _ = S.request(sock, frames, timeout_s=600)
            wall = time.perf_counter() - t1
            replies.append((imgs, is_pred, wall))
            log(f"slice: request {i}: {list(imgs.shape)} {imgs.dtype}, "
                f"{wall:.3f} s, {PRED / wall:.3f} predicted frames/s")
    finally:
        if server.is_alive():
            S.shutdown(sock)
        server.join(timeout=120)
        torch.cuda.synchronize()
        sock_dir.cleanup()
    launches = dict(_kernels.LAUNCHES)             # main path ends here
    if errors:
        raise errors[0]
    if server.is_alive():
        raise RuntimeError("serve loop did not stop")

    want_shape = (1, CONTEXT - 1 + PRED, FRAME, FRAME, 3)
    want_flags = [False] * (CONTEXT - 1) + [True] * PRED
    for imgs, is_pred, _ in replies:
        if (imgs.shape != want_shape or imgs.dtype != np.uint8
                or is_pred != want_flags):
            raise AssertionError(f"reply {imgs.shape} {imgs.dtype} "
                                 f"{is_pred}; expected {want_shape} uint8 "
                                 f"{want_flags}")
    n_unet = DDIMSchedule(DDIM_STEPS).n_steps - START_STEP
    per_frame = 4 + n_unet * UNET_ATTN_PER_FORWARD   # 2 VAE dec + 2 VAE enc
    per_batch = 1 + PRED * per_frame + 1             # context enc, final dec
    expected = (1 + REQUESTS) * per_batch            # warm-up + requests
    got = launches.get("flash_attention", 0)
    log(f"slice: flash_attention launches {got}, expected {expected} = "
        f"(1 warm-up + {REQUESTS} requests) x (1 + {PRED} x (4 + {n_unet} x "
        f"{UNET_ATTN_PER_FORWARD}) + 1)")
    if got != expected:
        raise AssertionError(f"flash_attention launched {got} times, the "
                             f"path implies {expected}")
    fps = [PRED / wall for _, _, wall in replies]
    log(f"slice: warm predicted frames/s at B=1: {fps} (mean "
        f"{float(np.mean(fps)):.4f}); total {time.perf_counter() - t_start:.1f}"
        f" s")
    return dict(launches=got, models=models)


def phase_check(models):
    dev = torch.device("cuda")
    vae, unet, clip, _ = models
    g = torch.Generator(device=dev).manual_seed(5)
    sample = torch.randn(1, 4, HI_RES // 8, HI_RES // 8, generator=g,
                         device=dev)
    t = torch.tensor([981.0], device=dev)
    ctx = SDPipeline(vae, unet, clip).uncond_embeddings(1)[:1]
    with torch.inference_mode():
        fwd = lambda: unet(sample, t, ctx)
        eps = fwd()
        with force_reference():
            eps_ref = fwd()
        torch.cuda.synchronize()
        _assert_finite("unet eps", eps)
        rel = ((eps - eps_ref).norm() / eps_ref.norm()).item()
        ms = cuda_ms(fwd, 5)
        with force_reference():
            ms_ref = cuda_ms(fwd, 5)
    log(f"check: 512px UNet forward bf16, kernel vs plain attention: rel L2 "
        f"{rel:.3e} (bound {UNET_REL_L2}); {ms:.2f} ms with the kernel, "
        f"{ms_ref:.2f} ms plain")
    if not rel <= UNET_REL_L2:
        raise AssertionError(f"UNet with the kernel: rel L2 {rel} > "
                             f"{UNET_REL_L2}")

    # The whole slice at small widths in f32: on the card with the kernel,
    # against the same weights and noise on the CPU with plain attention
    # (the version the CPU tests hold against the JAX package).
    noise = lambda step, shape: torch.randn(
        shape, generator=torch.Generator().manual_seed(step))
    cpu_models = _models(
        "cpu", torch.float32,
        VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                  norm_num_groups=8),
        UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                   attention_heads=2, cross_attention_dim=32,
                   norm_num_groups=8),
        CLIPTextConfig(hidden_size=32, num_layers=1, num_heads=2,
                       intermediate_size=64),
        dict(dim_model=64, num_heads=4, num_encoder_layers=1,
             num_decoder_layers=2, dim_feedforward=64), 16)
    gpu_models = [copy.deepcopy(m).to(dev) for m in cpu_models]
    frames = np.random.default_rng(1).integers(
        0, 256, (2, CONTEXT, 16, 16, 3), dtype=np.uint8)
    out = {}
    for name, ms_ in (("cpu", cpu_models), ("gpu", gpu_models)):
        codec, predict = _predict_fn(ms_, 16, 64, 3, noise_fn=noise)
        before = _kernels.LAUNCHES["flash_attention"]
        ctx, preds = predict(frames)
        img = codec.decode_latents(preds.reshape(-1, codec.latent_dim))
        launched = _kernels.LAUNCHES["flash_attention"] - before
        out[name] = (ctx.cpu(), preds.cpu(), img.cpu(), launched)
    if not (out["gpu"][3] > 0 and out["cpu"][3] == 0):
        raise AssertionError(f"small slice launches: {out['gpu'][3]} on the "
                             f"card, {out['cpu'][3]} on the CPU")
    ctx_err = (out["gpu"][0] - out["cpu"][0]).abs().max().item()
    lat_err = (out["gpu"][1] - out["cpu"][1]).abs().max().item()
    flips = (out["gpu"][2].int() - out["cpu"][2].int()).abs()
    flip_share = flips.float().mean().item()
    log(f"check: small f32 slice, card (kernel) vs CPU (plain): context max "
        f"abs {ctx_err:.3e}, preds max abs {lat_err:.3e} (bound "
        f"{SMALL_LATENT_ATOL}), pixels differing {flip_share:.4%} (bound "
        f"{SMALL_PIXEL_FLIP_SHARE:.0%}), max level difference "
        f"{flips.max().item()}")
    if not (max(ctx_err, lat_err) <= SMALL_LATENT_ATOL
            and flip_share <= SMALL_PIXEL_FLIP_SHARE
            and flips.max().item() <= 1):
        raise AssertionError("small slice: the card disagrees with the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernel()
    sl = phase_slice()
    phase_check(sl["models"])
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "sd_video_gen_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sd_video_gen_tpu/ops/attention.py:63",
        "launches": sl["launches"], **kern}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
