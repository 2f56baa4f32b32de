"""What the serving drivers share: the port's refined serving path built
from a configuration with the run's weights, one request through it, the
work of a request counted on the reference, and the comparison of served
requests with the plain reference.

A request is what the port's server answers: the clips' frames copied to
the card, the compiled predict program (the VAE encode with SOS, the
rollout with the per-frame 512px refiner), the compiled decode of the
context (less its last frame) and the predicted latents, and the uint8
frames fetched to the host.

The comparison follows the served request stage by stage from what the
program produced, as a served model's tokens are followed: the reference
encodes the clips (against the program's context latents); for each
predicted frame it runs the transformer on the program's own latents
before that frame and refines the result with the same noise (against
the program's refined latent); and it decodes the program's latents
(against the frames the program returned). Each number is the widest
relative L2 gap over the compared clips (and frames).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import roofline, weights
from benchmark.reference import pipeline as P
from benchmark.reference.clip_text import CLIPTextConfig, CLIPTextEncoder
from benchmark.reference.transformer import (FrameTransformer,
                                              FrameTransformerConfig)
from benchmark.reference.unet import UNet2DCondition, UNetConfig
from benchmark.reference.vae import AutoencoderKL, VAEConfig

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
MODULES = {"vae": (AutoencoderKL, VAEConfig), "unet": (UNet2DCondition,
                                                       UNetConfig),
           "clip": (CLIPTextEncoder, CLIPTextConfig),
           "transformer": (FrameTransformer, FrameTransformerConfig)}


def _kw(group: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in group.items()}


def latent_dim(cfg: dict) -> int:
    side = cfg["frame_size"] // 2 ** (len(cfg["vae"]["block_out_channels"])
                                      - 1)
    return cfg["vae"]["latent_channels"] * side * side


def reference_configs(cfg: dict) -> dict:
    tf = {k: v for k, v in cfg["transformer"].items() if k != "window"}
    return {"vae": VAEConfig(**_kw(cfg["vae"])),
            "unet": UNetConfig(**_kw(cfg["unet"])),
            "clip": CLIPTextConfig(**_kw(cfg["clip"])),
            "transformer": FrameTransformerConfig(latent_dim=latent_dim(cfg),
                                                  **tf)}


def named_shapes(cfg: dict) -> dict:
    """tag -> the (name, shape) list the run's weights are drawn for."""
    out = {}
    for tag, rc in reference_configs(cfg).items():
        m = roofline.meta_module(MODULES[tag][0], rc)
        out[tag] = weights.shapes_of(m)
    return out


def reference_models(cfg: dict, seed: int, device) -> dict:
    """The plain models in float32 with the run's weights (drawn again, in
    the configuration's dtype)."""
    dt = DTYPES[cfg["precision"]]
    out = {}
    for tag, rc in reference_configs(cfg).items():
        with torch.device(device):
            m = MODULES[tag][0](rc)
        weights.load(m, weights.seeded(weights.shapes_of(m), seed, tag,
                                       device, dt))
        out[tag] = m.eval().requires_grad_(False)
    return out


@dataclasses.dataclass
class Served:
    predict: object
    decode: object


def build_port(cfg: dict, seed: int, device, pred_frames: int) -> Served:
    """The port's predict and decode programs over its models, filled with
    the run's weights; not yet compiled."""
    from sd_video_gen_tpu_torch.config import strict_f32
    from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
    from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
    from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models import clip_text, transformer, unet, vae
    from sd_video_gen_tpu_torch.predict.predict import (make_decode_fn,
                                                        make_predict_fn)
    strict_f32()
    dt = DTYPES[cfg["precision"]]
    tf = {k: v for k, v in cfg["transformer"].items() if k != "window"}
    mods = {
        "vae": build(vae.AutoencoderKL, vae.VAEConfig(**_kw(cfg["vae"])),
                     device, dt),
        "unet": build(unet.UNet2DCondition,
                      unet.UNetConfig(**_kw(cfg["unet"])), device, dt),
        "clip": build(clip_text.CLIPTextEncoder,
                      clip_text.CLIPTextConfig(**_kw(cfg["clip"])), device,
                      dt),
        "transformer": build(transformer.FrameTransformer,
                             transformer.FrameTransformerConfig(
                                 latent_dim=latent_dim(cfg), **tf),
                             device, dt)}
    for tag, shapes in named_shapes(cfg).items():
        weights.load(mods[tag], weights.seeded(shapes, seed, tag, device, dt))
    r = cfg["refiner"]
    codec = VAECodec(cfg["frame_size"], mods["vae"])
    refine = make_denoise_refiner(
        SDPipeline(mods["vae"], mods["unet"], mods["clip"]),
        cfg["frame_size"], r["start_step"], r["num_inference_steps"],
        r["hi_res"], lambda step, shape: weights.noise(seed, step, shape,
                                                       device),
        sampler=r["sampler"])
    predict = make_predict_fn(mods["transformer"], codec, pred_frames,
                              window=cfg["transformer"]["window"], mode="ar",
                              refiner=refine)
    return Served(predict, make_decode_fn(codec))


@torch.inference_mode()
def request(served: Served, frames: np.ndarray):
    """One request -> (context latents, predicted latents) on the card and
    the returned frames (B, T_out, H, W, 3) uint8 on the host."""
    context, preds = served.predict(torch.from_numpy(frames))
    seq = torch.cat([context[:, :-1], preds], dim=1)
    imgs = served.decode(seq.reshape(-1, seq.shape[-1])).cpu().numpy()
    return context, preds, imgs.reshape(seq.shape[:2] + imgs.shape[1:])


def noise_rows(cfg: dict, seed: int, batch: int, rows, pred_frames: int,
               device) -> list:
    """The refiner's noise of each predicted frame for the clips at
    ``rows`` of requests of ``batch`` clips: (len(rows), h, h, c) a frame."""
    side = cfg["refiner"]["hi_res"] // 2 ** (
        len(cfg["vae"]["block_out_channels"]) - 1)
    shape = (batch, side, side, cfg["vae"]["latent_channels"])
    return [weights.noise(seed, i, shape, device)[list(rows)]
            for i in range(pred_frames)]


def _widest(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest relative L2 gap over the rows (clips) of ``a`` and ``b``."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())


@torch.no_grad()
def compare(models: dict, cfg: dict, frames, context, preds, imgs,
            noises) -> dict:
    """The three numbers for served clips: ``frames`` (N, T, H, W, 3)
    uint8, the program's ``context`` (N, T, L) and ``preds`` (N, P, L)
    latents and returned ``imgs`` (N, T - 1 + P, H, W, 3) uint8."""
    dev = next(models["vae"].parameters()).device
    frames, context, preds = (torch.as_tensor(x).to(dev)
                              for x in (frames, context, preds))
    N, T = frames.shape[:2]
    size, r = cfg["frame_size"], cfg["refiner"]
    ref_ctx = P.vae_encode(models["vae"], frames.reshape(
        (N * T,) + frames.shape[2:])).reshape(N, T, -1)
    text = P.empty_prompt(models["clip"])
    gaps = []
    for i in range(preds.shape[1]):
        raw = P.next_latent(models["transformer"], P.rollout_inputs(
            context.float(), preds.float(), i, cfg["transformer"]["window"]))
        ref = P.refine(models, raw, noises[i], size, r["hi_res"],
                       r["start_step"], text, r["num_inference_steps"])
        gaps.append(_widest(preds[:, i], ref))
    seq = torch.cat([context[:, :-1], preds], dim=1).float()
    ref_imgs = P.vae_decode(models["vae"], seq.reshape(-1, seq.shape[-1]),
                            size).reshape(torch.as_tensor(imgs).shape)
    return {"encode_rel": _widest(context, ref_ctx),
            "rollout_rel": max(gaps),
            "frames_rel": _widest(torch.as_tensor(imgs).to(dev), ref_imgs)}


@torch.no_grad()
def reference_request(models: dict, cfg: dict, frames, noises,
                      pred_frames: int):
    """The whole request on the reference, as the program runs it (the
    control's outputs, under ``layers.lowered``)."""
    dev = next(models["vae"].parameters()).device
    frames = torch.as_tensor(frames).to(dev)
    N, T = frames.shape[:2]
    size, r = cfg["frame_size"], cfg["refiner"]
    context = P.vae_encode(models["vae"], frames.reshape(
        (N * T,) + frames.shape[2:])).reshape(N, T, -1)
    text = P.empty_prompt(models["clip"])
    preds = torch.zeros(N, pred_frames, context.shape[-1], device=dev)
    for i in range(pred_frames):
        raw = P.next_latent(models["transformer"], P.rollout_inputs(
            context, preds, i, cfg["transformer"]["window"]))
        preds[:, i] = P.refine(models, raw, noises[i], size, r["hi_res"],
                               r["start_step"], text,
                               r["num_inference_steps"])
    seq = torch.cat([context[:, :-1], preds], dim=1)
    imgs = P.vae_decode(models["vae"], seq.reshape(-1, seq.shape[-1]), size)
    return context, preds, imgs.reshape((N, seq.shape[1]) + imgs.shape[1:])


def request_work(cfg: dict, clips: int, pred_frames: int) -> roofline.Work:
    """The useful work of one request of ``clips`` clips, counted on the
    reference on the meta device: each model counted once at each shape
    and multiplied by its calls."""
    rc = reference_configs(cfg)
    m = {tag: roofline.meta_module(MODULES[tag][0], c)
         for tag, c in rc.items()}
    size, r = cfg["frame_size"], cfg["refiner"]
    T, L = cfg["transformer"]["window"], latent_dim(cfg)
    fac = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    meta = torch.device("meta")

    def u8(n, s):
        return torch.zeros(n, s, s, 3, dtype=torch.uint8, device=meta)

    def lat(n, s):
        return torch.zeros(n, 4 * (s // fac) ** 2, device=meta)

    enc = lambda n, s: roofline.count(P.vae_encode, m["vae"], u8(n, s))
    dec = lambda n, s: roofline.count(P.vae_decode, m["vae"], lat(n, s), s)
    side = r["hi_res"] // fac
    sched_calls = r["num_inference_steps"] - r["start_step"]
    text = torch.zeros(clips, 77, rc["clip"].hidden_size, device=meta)
    unet = roofline.count(
        m["unet"], torch.zeros(clips, 4, side, side, device=meta),
        torch.zeros(clips, device=meta), text)
    tf = lambda t: roofline.count(
        P.next_latent, m["transformer"], torch.zeros(clips, t, L,
                                                     device=meta))
    per_frame = (dec(clips, size) + enc(clips, r["hi_res"])
                 + sched_calls * unet + dec(clips, r["hi_res"])
                 + enc(clips, size))
    return (enc(clips * T, size) + tf(T + 1) + (pred_frames - 1) * tf(T)
            + pred_frames * per_frame
            + dec(clips * (T - 1 + pred_frames), size))
