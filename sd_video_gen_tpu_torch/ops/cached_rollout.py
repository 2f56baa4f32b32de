"""KV-cached incremental AR rollout, the opt-in serving fast path
(``sd_video_gen_tpu/ops/cached_rollout.py``).

``ops/rollout.ar_rollout`` re-runs the whole encoder + decoder on the window
for every predicted frame. This module runs the seq2seq incremental decode:

  - the encoder runs once on [SOS + context]; its memory, and each decoder
    layer's cross-attention K/V of it, are frozen;
  - the decoder prefills over the context with the causal mask, recording
    each layer's self-attention K/V;
  - each new frame is one decoder step: fused QKV of a single token, K/V
    written into preallocated (B, Tmax, H, hd) caches, attention over the
    valid prefix (a validity mask over the whole cache).

Numerics contract: the first predicted frame is mathematically the full
rollout's (same src, same tgt, same causal math). From the second frame on
the schemes differ by construction: the full rollout feeds predictions back
through the encoder, this path conditions on the frozen context memory and
grows only the decoder sequence.

Pure functions over ``quantized.param_tree(model)`` (or the int8 tree of
``quantize_rollout_params``), not over the module's forward.
``jit_cached_rollout`` is the rollout as one compiled program per shape
(``utils/jit.py``), the JAX package's ``jit_cached_rollout``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from sd_video_gen_tpu_torch.models.positional import sinusoidal_positions
from sd_video_gen_tpu_torch.ops.masks import causal_mask
from sd_video_gen_tpu_torch.ops.quantized import (param_tree, qdense,
                                                  quantize_frame_transformer)
from sd_video_gen_tpu_torch.utils import profiling
from sd_video_gen_tpu_torch.utils.jit import jit

_LN_EPS = 1e-5  # torch nn.Transformer default, as in models/transformer.py


@functools.lru_cache(maxsize=8)
def positions(max_len: int, dim: int, device, dtype) -> torch.Tensor:
    """The sinusoidal table on ``device`` in ``dtype``, built once per
    argument set: a rollout reads it and copies nothing from the host (a
    pageable copy cannot be captured)."""
    return sinusoidal_positions(max_len, dim).to(device=device, dtype=dtype)


def _dense(p, x, dtype):
    if "q" in p:  # int8 serving tree
        return qdense(x, p["q"], p["bias"]).to(dtype)
    return F.linear(x.to(dtype), p["weight"].to(dtype), p["bias"].to(dtype))


def _ln(p, x):
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mean * mean
    y = (x - mean) * torch.rsqrt(var + _LN_EPS)
    return y * p["weight"].float() + p["bias"].float()


def _ffn(p, x, dtype):
    return _dense(p["lin2"], F.relu(_dense(p["lin1"], x, dtype)), dtype)


def _heads(x, H):
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H)


def _attend(q, k, v, mask, dtype):
    """q (B, Tq, H, hd), k/v (B, Tk, H, hd), additive mask broadcastable to
    (B, H, Tq, Tk) or None. Mirrors ``models/transformer.MultiheadAttention``:
    f32 logits and softmax, weights rounded to ``dtype``, f32 accumulation."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask.float()
    w = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
    B, Tq = out.shape[:2]
    return out.reshape(B, Tq, -1).to(dtype)


def _self_qkv(p, x, H, dtype):
    q, k, v = _dense(p["qkv"], x, dtype).chunk(3, dim=-1)
    return _heads(q, H), _heads(k, H), _heads(v, H)


def _enc_layer(p, x, H, dtype):
    q, k, v = _self_qkv(p["self_attn"], x, H, dtype)
    a = _dense(p["self_attn"]["out"], _attend(q, k, v, None, dtype), dtype)
    x = _ln(p["norm1"], x + a)
    return _ln(p["norm2"], x + _ffn(p, x, dtype))


def _cross_and_ffn(p, x, mem_k, mem_v, H, dtype):
    cq = _heads(_dense(p["cross_attn"]["q"], x, dtype), H)
    ca = _dense(p["cross_attn"]["out"],
                _attend(cq, mem_k, mem_v, None, dtype), dtype)
    x = _ln(p["norm2"], x + ca)
    return _ln(p["norm3"], x + _ffn(p, x, dtype))


def _dec_layer_prefill(p, x, mem_k, mem_v, mask, H, dtype):
    """Full causal decoder layer; returns (y, self-attn k, self-attn v)."""
    q, k, v = _self_qkv(p["self_attn"], x, H, dtype)
    a = _dense(p["self_attn"]["out"], _attend(q, k, v, mask, dtype), dtype)
    x = _ln(p["norm1"], x + a)
    return _cross_and_ffn(p, x, mem_k, mem_v, H, dtype), k, v


def _dec_layer_step(p, x, mem_k, mem_v, k_cache, v_cache, idx, mask, H,
                    dtype):
    """One-token decoder layer against the K/V caches, which it updates in
    place at position ``idx``; ``mask`` hides the cache beyond it."""
    q, k, v = _self_qkv(p["self_attn"], x, H, dtype)     # (B, 1, H, hd)
    k_cache[:, idx:idx + 1] = k
    v_cache[:, idx:idx + 1] = v
    a = _dense(p["self_attn"]["out"],
               _attend(q, k_cache, v_cache, mask, dtype), dtype)
    x = _ln(p["norm1"], x + a)
    return _cross_and_ffn(p, x, mem_k, mem_v, H, dtype)


def cached_rollout(cfg, params, context: torch.Tensor, pred_frames: int,
                   refine_fn=None) -> torch.Tensor:
    """Frozen-memory incremental rollout.

    cfg: the model's ``FrameTransformerConfig`` (mode 'ar').
    params: the ``FrameTransformer`` itself, its ``param_tree`` or the int8
      tree of ``quantize_rollout_params``.
    context: (B, T0, latent_dim), [SOS + context frames] (``encode_batch``).
    refine_fn: optional ``(latents (B, L), step) -> (B, L)`` per-step hook,
      applied to each prediction before it feeds back, as in ``ar_rollout``.

    Returns (B, pred_frames, latent_dim) f32.
    """
    if cfg.mode != "ar":
        raise AssertionError("cached_rollout supports mode='ar'")
    if cfg.pe_mode == "reference_batch":
        raise AssertionError(
            "cached_rollout does not implement pe_mode='reference_batch' -- "
            "use the full ar_rollout (--rollout full)")
    p = param_tree(params) if isinstance(params, nn.Module) else params
    H, D, dtype = cfg.num_heads, cfg.model_width, p["dtype"]
    scale = math.sqrt(D)
    B, T0, L = context.shape
    Tmax = T0 + pred_frames
    if Tmax > cfg.max_len:
        raise AssertionError(f"rollout length {Tmax} exceeds positional "
                             f"table max_len={cfg.max_len}")
    dev = context.device
    pos = positions(cfg.max_len, D, dev, dtype)

    def embed(x, t_start):
        e = _dense(p["embedding"], x, dtype) * scale
        return e + pos[None, t_start:t_start + e.shape[1]]

    # -- encoder: once -------------------------------------------------------
    profiling.mark("rollout", dev)
    h = embed(context, 0)
    for lp in p["enc"]:
        h = _enc_layer(lp, h, H, dtype)
    memory = _ln(p["enc_norm"], h).to(dtype)

    # cross-attention K/V of the frozen memory: once per layer
    mems = []
    for lp in p["dec"]:
        mk, mv = _dense(lp["cross_attn"]["kv"], memory, dtype).chunk(2, -1)
        mems.append((_heads(mk, H), _heads(mv, H)))

    # -- decoder prefill over the context (causal), recording K/V -----------
    hd = D // H
    k_caches = [torch.zeros((B, Tmax, H, hd), dtype=dtype, device=dev)
                for _ in p["dec"]]
    v_caches = [torch.zeros_like(c) for c in k_caches]
    x = embed(context, 0)
    mask = causal_mask(T0, device=dev)
    for i, lp in enumerate(p["dec"]):
        x, k, v = _dec_layer_prefill(lp, x, *mems[i], mask, H, dtype)
        k_caches[i][:, :T0] = k
        v_caches[i][:, :T0] = v
    x = _ln(p["dec_norm"], x).to(dtype)
    latent = _dense(p["out"], x[:, -1:], dtype).float()           # (B, 1, L)
    if refine_fn is not None:
        latent = refine_fn(latent[:, 0], 0)[:, None]
    preds = [latent[:, 0]]

    # -- incremental steps: step i takes prediction i at position T0 - 1 + i -
    slots = torch.arange(Tmax, device=dev)
    for i in range(1, pred_frames):
        profiling.mark("rollout", dev)
        idx = T0 - 1 + i
        x = _dense(p["embedding"], latent, dtype) * scale
        x = x + pos[None, idx:idx + 1]
        valid = (slots <= idx)[None, None, None, :]
        step_mask = torch.where(valid, 0.0, float("-inf"))
        for l, lp in enumerate(p["dec"]):
            x = _dec_layer_step(lp, x, *mems[l], k_caches[l], v_caches[l],
                                idx, step_mask, H, dtype)
        x = _ln(p["dec_norm"], x).to(dtype)
        latent = _dense(p["out"], x, dtype).float()               # (B, 1, L)
        if refine_fn is not None:
            latent = refine_fn(latent[:, 0], i)[:, None]
        preds.append(latent[:, 0])
    return torch.stack(preds, dim=1)


def jit_cached_rollout(cfg, pred_frames: int):
    """``cached_rollout`` with a static frame count, compiled: ``f(params,
    context)``, one graph per context shape and ``params`` object (the
    graph reads its weights where they lie)."""
    return jit(lambda params, context: cached_rollout(cfg, params, context,
                                                      pred_frames),
               name="cached_rollout")


def quantize_rollout_params(model) -> dict:
    """``FrameTransformer`` -> the int8 serving tree for ``cached_rollout``
    (every Linear as ``{q: QTensor, bias}``, norms as they are): the tree of
    ``quantize_frame_transformer``, which both int8 paths of the port walk."""
    return quantize_frame_transformer(model)
