"""Prediction entry point (``make_predict_fn`` of
``sd_video_gen_tpu/predict/predict.py``).

frames (B, T, H, W, 3) uint8 -> codec encode + SOS -> rollout with the
optional per-frame refiner -> (context latents, predicted latents). Variants
are arguments:

  mode 'ar'                    autoregressive rollout
  mode 'diff'                  residual rollout: each predicted latent is the
                               model's output plus the last input latent
  mode 'future'/'learned_tgt'  single shot: k frames from one forward
  mode 'text'                  AR rollout conditioned on text embeddings
  rollout 'cached'             the KV-cached frozen-memory path (mode 'ar')
  int8                         int8 products (modes 'ar' / 'diff')

An ``IdentityModel`` in place of the transformer is the copy-last-frame
baseline. The CLI (``main``) and checkpoint loading are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sd_video_gen_tpu_torch.ops.cached_rollout import (cached_rollout,
                                                       quantize_rollout_params)
from sd_video_gen_tpu_torch.ops.quantized import (quantize_frame_transformer,
                                                  quantized_ar_apply)
from sd_video_gen_tpu_torch.ops.rollout import ar_rollout


def make_predict_fn(model: torch.nn.Module, codec, pred_frames: int,
                    window: int, mode: str = "ar",
                    refiner: Optional[Callable] = None,
                    rollout: str = "full", int8: bool = False,
                    future_horizon: Optional[int] = None):
    """``predict(frames_u8, text_embeds=None) -> (context_latents (B, T, L),
    preds (B, P, L))``.

    ``codec`` is a ``PixelCodec`` or ``VAECodec``; ``refiner`` the hook from
    ``diffusion/refine.make_denoise_refiner``. ``mode='text'`` takes text
    embeddings (B, text_embed_dim) as the second argument. With ``int8`` the
    model's Linear weights are quantised here, once.

    ``rollout='cached'`` (mode 'ar' only): frame 1 is the full re-forward's,
    later frames condition on the frozen context memory instead of
    re-encoding predictions.
    """
    if rollout == "cached" and mode != "ar":
        raise ValueError("--rollout cached supports --train_mode ar only")
    if mode in ("future", "learned_tgt") and future_horizon is not None \
            and pred_frames > future_horizon:
        raise ValueError(
            f"pred_frames {pred_frames} exceeds the model's trained future "
            f"horizon {future_horizon} (frames_to_predict)")
    if int8 and mode not in ("ar", "diff"):
        raise ValueError("--int8 supports --train_mode ar/diff only")

    apply_fn = model
    cached_params = model
    if int8 and rollout == "cached":
        cached_params = quantize_rollout_params(model)
    elif int8:
        qp = quantize_frame_transformer(model)
        H, pe = model.cfg.num_heads, model.cfg.pe_mode

        def apply_fn(src, tgt, tgt_mask=None, **kw):
            return quantized_ar_apply(qp, src, tgt, tgt_mask=tgt_mask,
                                      num_heads=H, pe_mode=pe)
    if mode == "diff":
        base_apply = apply_fn

        def apply_fn(src, tgt, tgt_mask=None, **kw):
            out = base_apply(src, tgt, tgt_mask=tgt_mask, **kw)
            # residual: next latent = model output + last input frame
            return torch.cat([out[:, :-1],
                              (out[:, -1] + tgt[:, -1])[:, None]], dim=1)

    @torch.inference_mode()
    def predict(frames_u8, text_embeds=None):
        frames = (frames_u8 if isinstance(frames_u8, torch.Tensor) else
                  torch.from_numpy(np.array(frames_u8, np.uint8)))
        latents = codec.encode_batch(frames.to(codec.device), use_sos=True)
        kwargs = {"text_embeds": text_embeds} if text_embeds is not None \
            else {}
        if mode in ("future", "learned_tgt"):
            # single shot: the model's last ``frames_to_predict`` outputs are
            # future frames 1..k, so fewer than k means the FIRST pred_frames
            # of that span; learned_tgt ignores tgt and decodes its queries
            y_in = latents[:, 1:]                   # drop SOS
            out = model(y_in, y_in, tgt_mask=None, **kwargs)
            k = future_horizon or pred_frames
            preds = out[:, -k:][:, :pred_frames]
            if refiner is not None:
                preds = torch.stack([refiner(preds[:, i], i)
                                     for i in range(preds.shape[1])], dim=1)
        elif rollout == "cached":
            preds = cached_rollout(model.cfg, cached_params, latents,
                                   pred_frames, refine_fn=refiner)
        else:
            preds = ar_rollout(apply_fn, latents, pred_frames, window=window,
                               refine_fn=refiner, model_kwargs=kwargs)
        return latents[:, 1:], preds

    return predict
