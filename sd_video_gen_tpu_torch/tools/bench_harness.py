"""What the port's benchmark (``sd_video_gen_tpu_torch/bench.py``) and
``chip_smoke.py`` share: the paths' sizes, the models they run, the exact
kernel launches those models imply, the device-time buckets of a trace, the
host's cost of a kernel-wrapper call, and the card's published peaks.

The counterpart of ``tools/_bench_harness.py`` beside the JAX package, whose
TPU timing patterns (chained scans, cost analysis) have no place here: a
card's time is taken with ``torch.cuda.synchronize`` and ``torch.profiler``.

The sizes are the JAX bench's (``bench.py``): 64px frames, 5 context frames,
the flagship FrameTransformer (dim 2048, 8 heads, 4 + 8 layers), SD-v1.4's
VAE / UNet / CLIP-text at their published widths, and the training runs of
``bench.py``'s ``scenario_train*``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                     CLIPTextEncoder)
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import (Transformer2D,
                                                UNet2DCondition, UNetConfig)
from sd_video_gen_tpu_torch.models.vae import (AttnBlock, AutoencoderKL,
                                               VAEConfig)
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops import groupnorm as gn
from sd_video_gen_tpu_torch.ops.attention import (ROUTE_LAUNCHES,
                                                  flash_attention, route)
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn
from sd_video_gen_tpu_torch.train.trainer import Trainer

FRAME, CONTEXT, HI_RES, DDIM_STEPS = 64, 5, 512, 50
FLAGSHIP = dict(dim_model=2048, num_heads=8, num_encoder_layers=4,
                num_decoder_layers=8)
# The predict paths, served in this order; names and sizes are the JAX
# bench's (bench.py). ``requests`` are clips per request after the warm-up
# batch; ``refine`` is the per-frame partial denoise (``hi_res=None``: on the
# native latent grid); ``model`` names the transformer (``full_width_models``,
# ``mode_models`` in chip_smoke.py). Keys left out take ``PATH_DEFAULTS``.
PATH_DEFAULTS = dict(codec="pixel", pred=4, refine=None, mode="ar",
                     model="ar", rollout="full", int8=False,
                     future_horizon=None, labels=False)
PATHS = [dict(PATH_DEFAULTS, **p) for p in (
    dict(name="vae_denoise_ar4", codec="vae", batch_clips=1, requests=[1, 1],
         refine=dict(hi_res=HI_RES, start_step=40, sampler="ddim",
                     solver_steps=None)),
    dict(name="vae_denoise_ar4_8streams_dpmpp5", codec="vae", batch_clips=8,
         requests=[8, 8, 3],
         refine=dict(hi_res=HI_RES, start_step=40, sampler="dpmpp",
                     solver_steps=5)),
    dict(name="pixel_ar16", batch_clips=256, pred=16, requests=[256, 256]),
    dict(name="pixel_ar16_int8", batch_clips=256, pred=16, int8=True,
         requests=[256, 256]),
    dict(name="pixel_ar16_kvcache", batch_clips=256, pred=16,
         rollout="cached", requests=[256, 256]),
    dict(name="pixel_ar16_kvcache_int8", batch_clips=256, pred=16,
         rollout="cached", int8=True, requests=[256, 256]),
    dict(name="vae_ar16", codec="vae", batch_clips=32, pred=16,
         requests=[32, 32]),
    dict(name="vae_denoise_native_ar4", codec="vae", batch_clips=8,
         rollout="cached", requests=[8, 8],
         refine=dict(hi_res=None, start_step=48, sampler="ddim",
                     solver_steps=None)),
    dict(name="mode_diff", mode="diff", batch_clips=8, requests=[8]),
    dict(name="mode_future", mode="future", model="future", batch_clips=8,
         future_horizon=5, requests=[8]),
    dict(name="mode_learned_tgt", mode="learned_tgt", model="learned_tgt",
         batch_clips=8, future_horizon=5, requests=[8]),
    dict(name="mode_text", mode="text", model="text", batch_clips=8,
         labels=True, requests=[8]),
    dict(name="identity_baseline", model="identity", batch_clips=8,
         requests=[8]))]
# The two 512px refiner paths: what chip_smoke.py --tune times.
REFINER_PATHS = ("vae_denoise_ar4", "vae_denoise_ar4_8streams_dpmpp5")
# The SD pipeline at 512px, B=1, guidance 7.5: ``unet_calls`` of batch 2 each.
SD_GUIDANCE, SD_RUNS = 7.5, 3                 # one warm-up run + two timed
SD_PATHS = [
    dict(name="sd_txt2img_lms50", sampler="lms", steps=50, unet_calls=50),
    dict(name="sd_txt2img_dpmpp20", sampler="dpmpp", steps=20, unet_calls=20),
    dict(name="sd_img2img_ddim", sampler="ddim", steps=DDIM_STEPS,
         start_step=10, unet_calls=40)]
# The training paths: names and sizes are the JAX bench's (bench.py
# scenario_train, scenario_train_tuned, scenario_train_ref_artifact).
# chip_smoke.py takes TRAIN_WARMUP + TRAIN_TIMED + 1 optimizer steps of each
# on one fixed batch; the benchmark times TRAIN_TIMED steps a repeat.
TRAIN_FRAME, TRAIN_WARMUP, TRAIN_TIMED = 128, 2, 8
_FLAGSHIP_TRAIN = dict(
    config_name="11_27_ucf_final", lr=1e-5, frames_per_clip=5,
    frames_to_predict=5, frame_size=TRAIN_FRAME, dropout_p=0.1, use_mse=True,
    use_gdl=True, lambda_gdl=1.0, use_contrastive=True,
    lambda_contrastive=0.025, **FLAGSHIP)
TRAIN_PATHS = [
    dict(name="train_flagship", codec="pixel", precision="bf16_full",
         clip_frames=10, cfg=Config(batch_size=6, **_FLAGSHIP_TRAIN)),
    dict(name="train_flagship_tuned", codec="pixel", precision="bf16_full",
         clip_frames=10, cfg=Config(batch_size=288, **_FLAGSHIP_TRAIN)),
    # the reference's own recorded run: the VAE encode of the pixel batch
    # inside every step, f32, MSE + GDL
    dict(name="train_ref_artifact", codec="vae", precision="f32",
         clip_frames=5, cfg=Config(
             config_name="config_test", lr=1e-4, batch_size=64,
             frames_per_clip=5, frames_to_predict=5, frame_size=TRAIN_FRAME,
             dim_model=256, num_heads=8, num_encoder_layers=6,
             num_decoder_layers=6, dropout_p=0.1, use_mse=True, use_gdl=True,
             lambda_gdl=1.0, use_contrastive=False))]

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its full
# 700 W), for the kernels' bounds and the benchmark's MFU.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989.4e12
TF32_FLOPS = 494.7e12
F32_FLOPS = 67e12      # CUDA cores, outside the tensor cores
INT8_OPS = 1978.9e12
# The MFU denominator of a scenario, by the precision of its products: the
# fastest rate the card has for them. f32 at full f32 accuracy is three TF32
# products on the tensor cores (K1's tf32x3 body), so TF32 / 3; TF32 itself
# stays off (config.strict_f32). Products in a slower type than the peak's
# only lower the share, so no scenario can read above 1.
MFU_PEAKS = {"bf16": BF16_FLOPS, "f32": TF32_FLOPS / 3, "int8": INT8_OPS}
KERNELS = {
    "flash_attention": dict(
        source="sd_video_gen_tpu_torch/csrc/flash_attention.cu",
        replaces="sd_video_gen_tpu/ops/attention.py:63"),
    "groupnorm_silu": dict(
        source="sd_video_gen_tpu_torch/csrc/groupnorm_silu_nhwc.cu",
        replaces="sd_video_gen_tpu/ops/groupnorm.py:35"),
}
# Device-time buckets of a trace, by kernel name; the first match wins.
PROFILE_BUCKETS = (
    ("K1 flash attention", ("flash_fwd",)),
    ("K2 GroupNorm+SiLU", ("gn_nhwc", "gn_partial", "gn_stats", "gn_apply")),
    ("NCHW<->NHWC transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolutions", ("conv2d", "convolution", "cudnn", "xmma", "fprop",
                      "implicit_gemm", "conv_")),
    ("matrix products", ("gemm", "nvjet", "cublas", "gemv")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("softmax", ("softmax",)),
    ("copies / cat", ("copy", "catarray", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
)


def log(*a):
    print(*a, flush=True)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def assert_finite(name, x):
    if not torch.isfinite(x).all():
        raise AssertionError(f"{name}: non-finite values")
    return x


def checked_refine(refine):
    """The refiner, failing on a non-finite latent in or out."""
    def run(flat, step):
        assert_finite(f"predicted latent (step {step})", flat)
        return assert_finite(f"refined latent (step {step})",
                             refine(flat, step))
    return run


def checked_predict(predict):
    """The predict entry point, failing on non-finite latents."""
    def run(frames, text_embeds=None):
        context, preds = predict(frames, text_embeds)
        return assert_finite("context", context), assert_finite("preds",
                                                                preds)
    return run


def build_models(device, dtype, vae_cfg, unet_cfg, clip_cfg, ft_dims, frame):
    """VAE, UNet, CLIP-text and the mode-'ar' FrameTransformer, seeded, built
    on device."""
    vae = build(AutoencoderKL, vae_cfg, device, dtype, seed=0)
    latent_dim = VAECodec(frame, vae).latent_dim
    return dict(
        device=torch.device(device), dtype=dtype, vae=vae,
        unet=build(UNet2DCondition, unet_cfg, device, dtype, seed=1),
        clip=build(CLIPTextEncoder, clip_cfg, device, dtype, seed=2),
        ar=build(FrameTransformer, FrameTransformerConfig(
            latent_dim=latent_dim, **ft_dims), device, dtype, seed=3))


def predict_fn(models, path, frame=FRAME, hi_res=None, pred=None,
               noise_fn=None, checked=False):
    """The port's predict entry point for ``path`` over ``models``; ``hi_res``
    and ``pred`` replace the path's (the small-width runs)."""
    dev = models["device"]
    codec = (VAECodec(frame, models["vae"]) if path["codec"] == "vae"
             else PixelCodec(frame, dev))
    refine = None
    if path["refine"] is not None:
        r = path["refine"]
        refine = make_denoise_refiner(
            SDPipeline(models["vae"], models["unet"], models["clip"]), frame,
            r["start_step"], DDIM_STEPS,
            r["hi_res"] and (hi_res or r["hi_res"]), noise_fn,
            sampler=r["sampler"], solver_steps=r["solver_steps"])
        if checked:
            refine = checked_refine(refine)
    predict = make_predict_fn(
        models[path["model"]], codec, pred or path["pred"], window=CONTEXT,
        mode=path["mode"], refiner=refine, rollout=path["rollout"],
        int8=path["int8"], future_horizon=path["future_horizon"])
    return codec, checked_predict(predict) if checked else predict


def full_width_models():
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t0 = time.perf_counter()
    models = build_models(dev, bf16, VAEConfig(), UNetConfig(),
                          CLIPTextConfig(), FLAGSHIP, FRAME)
    n_params = sum(p.numel() for m in models.values()
                   if isinstance(m, nn.Module) for p in m.parameters())
    torch.cuda.synchronize()
    log(f"models: built {n_params / 1e6:.1f}M params bf16 on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    return models


def train_frames(path, seed=0) -> np.ndarray:
    cfg = path["cfg"]
    return np.random.default_rng(seed).integers(
        0, 256, (cfg.batch_size, path["clip_frames"], cfg.frame_size,
                 cfg.frame_size, 3), dtype=np.uint8)


def make_trainer(path, workdir, seed=0, device="cuda", vae=None) -> Trainer:
    """The port's Trainer for a training path, its state initialised from
    ``seed``; checkpoints and logs under ``workdir``. ``vae``: the frozen
    codec of a ``vae`` path (the SD VAE in f32 from seed 0 when None)."""
    trainer = Trainer(path["cfg"], mode="ar", codec_kind=path["codec"],
                      checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      log_dir=os.path.join(workdir, "logs"), use_wandb=False,
                      precision=path["precision"], device=device, vae=vae)
    trainer.logger.quiet = True
    trainer.init_state(seed=seed)
    return trainer


def passes_per_model(models) -> dict:
    """Kernel launches per (VAE encode, VAE decode, UNet forward); no UNet
    (``models["unet"]`` None) launches none."""
    vae, unet = models["vae"], models["unet"]
    count = lambda m, cls: (0 if m is None else
                            sum(isinstance(x, cls) for x in m.modules()))
    return {"flash_attention": (count(vae.encoder, AttnBlock),
                                count(vae.decoder, AttnBlock),
                                count(unet, Transformer2D)),
            "groupnorm_silu": (count(vae.encoder, nn.GroupNorm),
                               count(vae.decoder, nn.GroupNorm),
                               count(unet, nn.GroupNorm))}


def expected_launches(models, path, batches: int) -> dict:
    """Launches of each kernel in ``batches`` batches of a predict path, from
    the models' structure: every GroupNorm module runs once per pass, flash
    attention once per VAE attention block and per UNet Transformer2D
    (attn1). A path with neither the VAE codec nor a refiner reaches no
    kernel (its ``models`` need hold no SD model)."""
    if path["codec"] != "vae" and path["refine"] is None:
        return {name: 0 for name in KERNELS}
    out = {}
    for name, (enc, dec, un) in passes_per_model(models).items():
        codec = path["codec"] == "vae"
        per_frame, r = 0, path["refine"]
        if r is not None:
            n_unet = (DDIMSchedule(DDIM_STEPS).n_steps - r["start_step"]
                      if r["sampler"] == "ddim" else r["solver_steps"])
            # at hi_res: 2 VAE dec + 2 VAE enc around the UNet calls
            per_frame = n_unet * un + (2 * (dec + enc) if r["hi_res"] else 0)
        # context encode; the refiner per frame; the final decode
        out[name] = batches * (codec * enc + path["pred"] * per_frame
                               + codec * dec)
        log(f"{path['name']}: {name} expected {out[name]} = {batches} "
            f"batches x ({codec * enc} + {path['pred']} x {per_frame} + "
            f"{codec * dec})")
    return out


class launch_window:
    """Counts of the main path: every count set to 0 on entry, read on exit
    (``launches``, and launches by body of each kernel)."""

    def __enter__(self):
        _kernels.LAUNCHES.clear()
        ROUTE_LAUNCHES.clear()
        gn.ROUTE_LAUNCHES.clear()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.launches = {k: _kernels.LAUNCHES.get(k, 0) for k in KERNELS}
        self.bodies = dict(ROUTE_LAUNCHES)
        self.gn_bodies = dict(gn.ROUTE_LAUNCHES)
        return False

    def check(self, name: str, expected: dict, flash_body="wgmma"):
        """Exact counts, every GroupNorm launch on the NHWC body and every
        flash launch on ``flash_body``: the bf16 tensor-core body on the
        serving paths, the f32 one (tf32x3) in the f32 training step; or,
        where a window runs both, ``flash_body`` is the exact launches by
        body."""
        log(f"{name}: launches {self.launches}; flash attention by body "
            f"{self.bodies}; GroupNorm by body {self.gn_bodies}")
        if self.gn_bodies.get("nhwc", 0) != self.launches["groupnorm_silu"]:
            raise AssertionError(f"{name}: GroupNorm left the NHWC body: "
                                 f"{self.gn_bodies}")
        bodies = (flash_body if isinstance(flash_body, dict) else
                  {flash_body: self.launches["flash_attention"]})
        nonzero = lambda d: {b: n for b, n in d.items() if n}
        if nonzero(self.bodies) != nonzero(bodies):
            raise AssertionError(f"{name}: flash attention by body "
                                 f"{self.bodies}, the path implies {bodies}")
        for kernel, want in expected.items():
            if self.launches[kernel] != want:
                raise AssertionError(
                    f"{name}: {kernel} launched {self.launches[kernel]} "
                    f"times, the path implies {want}")


def bucket_of(kernel_name: str) -> str:
    key = kernel_name.lower()
    return next((b for b, words in PROFILE_BUCKETS
                 if any(w in key for w in words)), "other")


def device_breakdown(events) -> dict:
    """Device time of a trace (``prof.key_averages()``): ``ms`` in all,
    ``kernels`` (kernels and copies), ``buckets`` (ms by PROFILE_BUCKETS)
    and ``by_kernel`` ((ms, count, bucket, name), largest first)."""
    buckets, by_kernel, count, total = {}, [], 0, 0.0
    for e in events:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if not us:
            continue
        bucket = bucket_of(e.key)
        buckets[bucket] = buckets.get(bucket, 0.0) + us / 1e3
        by_kernel.append((us / 1e3, e.count, bucket, e.key))
        total += us / 1e3
        count += e.count
    if not total:
        raise AssertionError("profile: the trace shows no device time")
    return dict(ms=total, kernels=count,
                buckets=dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
                by_kernel=sorted(by_kernel, reverse=True))


def wrapper_host_cost() -> dict:
    """Host seconds per wrapper call on a tiny tensor (the device work is
    nothing): what each of a path's thousands of calls costs the Python
    thread, by (kernel, body)."""
    def per_call(fn) -> float:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        n, t0 = 3000, time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return host

    out = {}
    w = torch.ones(32, device="cuda", dtype=torch.bfloat16)
    for body in ("nhwc", "nchw"):
        x = torch.randn(1, 32, 8, 8, device="cuda", dtype=torch.bfloat16)
        if body == "nhwc":
            x = x.contiguous(memory_format=torch.channels_last)
        out[("groupnorm_silu", body)] = per_call(
            lambda: gn.groupnorm_silu(x, w, w, 8, 1e-6, True))
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 64, 40, device="cuda").to(dtype)
        body = route(dtype, 40, (q.data_ptr(),) * 3)
        out[("flash_attention", body)] = per_call(
            lambda: flash_attention(q, q, q))
    return out
