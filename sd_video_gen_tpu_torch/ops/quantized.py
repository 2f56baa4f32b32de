"""Int8 weight / activation quantisation for the AR serving path
(``sd_video_gen_tpu/ops/quantized.py``).

  - weights: per-output-channel symmetric int8 (absmax / 127)
  - activations: dynamic per-token symmetric int8
  - accumulation in int32 (``torch._int_mm``), rescaled by the outer product
    of the row and column scales in f32

``quantized_ar_apply`` mirrors ``FrameTransformer``'s 'ar' forward with every
Linear as a quantised product; softmax, layer norm and the residual stream
stay f32.

The parameter tree. The JAX package walks a flax tree; the port's functions
(here and in ``ops/cached_rollout.py``) walk ``param_tree(model)``, nested
dicts over the ``FrameTransformer``'s own tensors (views, no copies)::

    {"dtype", "embedding": D, "out": D, "enc_norm": N, "dec_norm": N,
     "enc": [{"self_attn": {"qkv": D, "out": D}, "lin1": D, "lin2": D,
              "norm1": N, "norm2": N}, ...],
     "dec": [{"self_attn": ..., "cross_attn": {"q": D, "kv": D, "out": D},
              "lin1", "lin2", "norm1", "norm2", "norm3"}, ...]}

with D = ``{"weight": (out, in), "bias"}`` and N = ``{"weight", "bias"}``;
``cross_attn`` splits the fused ``multihead_attn.in_proj_weight`` into its q
rows and its k|v rows. ``quantize_frame_transformer`` returns the same tree
with every D as ``{"q": QTensor, "bias"}``: scales are per output channel, so
quantising the fused rows equals quantising q, k and v apart.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.models.positional import sinusoidal_positions

# torch._int_mm on CUDA takes more than 16 rows, and K and N in multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ROW_PAD = 32


@dataclasses.dataclass
class QTensor:
    values: torch.Tensor  # int8 (in, out), column-major (the (out, in)
    #                       weight's own memory), as cuBLASLt's int8 product
    #                       wants its second operand
    scale: torch.Tensor   # f32 (out,)


def quantize_weight(w: torch.Tensor) -> QTensor:
    """(in, out) f32/bf16 -> per-out-channel symmetric int8."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q.t().contiguous().t(), scale)


def _int_mm(xi: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. On the card rows are padded
    with zeros to what ``torch._int_mm`` takes; K or N it cannot take raise:
    there is no float product to fall back to."""
    M, K = xi.shape
    if xi.is_cuda:
        if K % 8 or values.shape[1] % 8:
            raise ValueError(f"int8 product ({M}, {K}) x {tuple(values.shape)}"
                             f": torch._int_mm on CUDA needs K and N in "
                             f"multiples of 8")
        if M < _INT_MM_MIN_ROWS:
            pad = xi.new_zeros((_INT_MM_ROW_PAD, K))
            pad[:M] = xi
            return torch._int_mm(pad, values)[:M]
    return torch._int_mm(xi, values)


def qdense(x: torch.Tensor, q: QTensor, bias=None) -> torch.Tensor:
    """(..., in) @ int8 weights with dynamic per-token activation quant;
    f32 out."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    xi = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = _int_mm(xi.reshape(-1, xi.shape[-1]), q.values)
    y = acc.reshape(*xi.shape[:-1], -1).float() * sx * q.scale
    if bias is not None:
        y = y + bias.float()
    return y


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + 1e-5) * p["weight"].float()
            + p["bias"].float())


def param_tree(model) -> dict:
    """The ``FrameTransformer``'s (mode 'ar') tensors as the nested dicts the
    module docstring lays out. Views of the parameters; nothing is copied."""
    dense = lambda lin: {"weight": lin.weight, "bias": lin.bias}
    norm = lambda ln: {"weight": ln.weight, "bias": ln.bias}

    def self_attn(a):
        return {"qkv": {"weight": a.in_proj_weight, "bias": a.in_proj_bias},
                "out": dense(a.out_proj)}

    def cross_attn(a):
        D = a.in_proj_weight.shape[1]
        w, b = a.in_proj_weight, a.in_proj_bias
        return {"q": {"weight": w[:D], "bias": b[:D]},
                "kv": {"weight": w[D:], "bias": b[D:]},
                "out": dense(a.out_proj)}

    def layer(l, decoder):
        out = {"self_attn": self_attn(l.self_attn), "lin1": dense(l.linear1),
               "lin2": dense(l.linear2), "norm1": norm(l.norm1),
               "norm2": norm(l.norm2)}
        if decoder:
            out["cross_attn"] = cross_attn(l.multihead_attn)
            out["norm3"] = norm(l.norm3)
        return out

    t = model.transformer
    return {"dtype": model.embedding.weight.dtype,
            "embedding": dense(model.embedding), "out": dense(model.out),
            "enc_norm": norm(t.encoder.norm), "dec_norm": norm(t.decoder.norm),
            "enc": [layer(l, False) for l in t.encoder.layers],
            "dec": [layer(l, True) for l in t.decoder.layers]}


def quantize_tree(tree):
    """Every ``{"weight", "bias"}`` with a 2-D weight -> ``{"q", "bias"}``;
    norms and everything else pass through."""
    if isinstance(tree, dict):
        if set(tree) == {"weight", "bias"} and tree["weight"].dim() == 2:
            return {"q": quantize_weight(tree["weight"].t()),
                    "bias": tree["bias"]}
        return {k: quantize_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [quantize_tree(v) for v in tree]
    return tree


def quantize_frame_transformer(model) -> dict:
    """``FrameTransformer`` (mode 'ar') -> its int8 tree (Linear -> QTensor)."""
    return quantize_tree(param_tree(model))


@functools.lru_cache(maxsize=8)
def _positions(max_len: int, dim: int, device) -> torch.Tensor:
    return sinusoidal_positions(max_len, dim).to(device)


def _mha(x_q, x_kv, a, num_heads, mask=None):
    if "qkv" in a:
        qkv = qdense(x_q, a["qkv"]["q"], a["qkv"]["bias"])
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        q = qdense(x_q, a["q"]["q"], a["q"]["bias"])
        k, v = qdense(x_kv, a["kv"]["q"], a["kv"]["bias"]).chunk(2, dim=-1)
    B, Tq, D = q.shape
    hd = D // num_heads
    q = q.reshape(B, Tq, num_heads, hd)
    k = k.reshape(B, -1, num_heads, hd)
    v = v.reshape(B, -1, num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, D)
    return qdense(o, a["out"]["q"], a["out"]["bias"])


def quantized_ar_apply(qp, src, tgt, tgt_mask=None, num_heads: int = 8,
                       max_len: int = 64, pe_mode: str = "timestep"):
    """``FrameTransformer`` mode 'ar' forward with int8 products, over the
    tree from ``quantize_frame_transformer``.

    Implements the per-timestep positional encoding only: a checkpoint
    served under ``pe_mode='reference_batch'`` must use the float path."""
    if pe_mode != "timestep":
        raise AssertionError(
            "quantized_ar_apply implements pe_mode='timestep' only")
    D = qp["embedding"]["q"].values.shape[1]
    scale = math.sqrt(D)
    pos = _positions(max_len, D, src.device)
    emb = qp["embedding"]
    src = qdense(src, emb["q"], emb["bias"]) * scale
    tgt = qdense(tgt, emb["q"], emb["bias"]) * scale
    src = src + pos[None, : src.shape[1]]
    tgt = tgt + pos[None, : tgt.shape[1]]

    def ffn(x, f):
        h = F.relu(qdense(x, f["lin1"]["q"], f["lin1"]["bias"]))
        return qdense(h, f["lin2"]["q"], f["lin2"]["bias"])

    m = src
    for e in qp["enc"]:
        m = _ln(m + _mha(m, m, e["self_attn"], num_heads), e["norm1"])
        m = _ln(m + ffn(m, e), e["norm2"])
    m = _ln(m, qp["enc_norm"])
    x = tgt
    for d in qp["dec"]:
        x = _ln(x + _mha(x, x, d["self_attn"], num_heads, tgt_mask),
                d["norm1"])
        x = _ln(x + _mha(x, m, d["cross_attn"], num_heads), d["norm2"])
        x = _ln(x + ffn(x, d), d["norm3"])
    x = _ln(x, qp["dec_norm"])
    return qdense(x, qp["out"]["q"], qp["out"]["bias"])
