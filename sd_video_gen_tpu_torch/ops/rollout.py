"""Autoregressive rollout as a Python loop (``sd_video_gen_tpu/ops/rollout.py``).

  step 0: condition on [SOS + all context frames]
  steps 1..P-1: a sliding window of the last ``window`` latents (real frames
          only). A context shorter than the window is left-padded by
          repeating its first frame, as the JAX package does for its static
          scan buffer.

The refine hook (partial denoise) receives the rollout step index, so each
frame draws fresh noise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sd_video_gen_tpu_torch.ops.masks import causal_mask


def _predict_next(model, seq, refine_fn, model_kwargs, step: int):
    """Full-sequence forward; take the last predicted latent."""
    mask = causal_mask(seq.shape[1], device=seq.device)
    nxt = model(seq, seq, tgt_mask=mask, **model_kwargs)[:, -1]
    if refine_fn is not None:
        nxt = refine_fn(nxt, step)
    return nxt


def ar_rollout(model: Callable, context: torch.Tensor, pred_frames: int,
               window: int = 5,
               refine_fn: Optional[Callable] = None,
               model_kwargs: Optional[dict] = None) -> torch.Tensor:
    """Roll ``model(src, tgt, tgt_mask=...)`` forward ``pred_frames`` steps.

    context: (B, T0, L), SOS + context-frame latents (``encode_batch``).
    refine_fn: optional ``(latents (B, L), step) -> (B, L)`` hook.
    model_kwargs: passed to every model call (text mode's ``text_embeds``).
    Returns (B, pred_frames, L).
    """
    model_kwargs = model_kwargs or {}
    first = _predict_next(model, context, refine_fn, model_kwargs, 0)
    preds = [first]
    frames = context[:, 1:]  # drop SOS
    buf = torch.cat([frames[:, :-1], first[:, None]], dim=1)[:, -window:]
    if buf.shape[1] < window:
        pad = buf[:, :1].expand(-1, window - buf.shape[1], -1)
        buf = torch.cat([pad, buf], dim=1)
    for i in range(1, pred_frames):
        nxt = _predict_next(model, buf, refine_fn, model_kwargs, i)
        buf = torch.cat([buf[:, 1:], nxt[:, None]], dim=1)
        preds.append(nxt)
    return torch.stack(preds, dim=1)
