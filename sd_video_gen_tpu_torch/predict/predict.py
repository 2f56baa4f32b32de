"""AR prediction entry point (``make_predict_fn`` of
``sd_video_gen_tpu/predict/predict.py``, mode 'ar', full rollout).

frames (B, T, H, W, 3) uint8 -> VAE encode + SOS -> AR rollout with the
optional per-frame refiner -> (context latents, predicted latents). The CLI
(`main`), the other modes, the cached and int8 rollouts are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.ops.rollout import ar_rollout


def make_predict_fn(model: torch.nn.Module, codec: VAECodec, pred_frames: int,
                    window: int, refiner: Optional[Callable] = None):
    """``predict(frames_u8) -> (context_latents (B, T, L), preds (B, P, L))``.

    ``refiner`` is the hook from ``diffusion/refine.make_denoise_refiner``.
    """

    @torch.inference_mode()
    def predict(frames_u8):
        frames = (frames_u8 if isinstance(frames_u8, torch.Tensor) else
                  torch.from_numpy(np.array(frames_u8, np.uint8)))
        latents = codec.encode_batch(frames.to(codec.device))
        preds = ar_rollout(model, latents, pred_frames, window=window,
                           refine_fn=refiner)
        return latents[:, 1:], preds

    return predict
