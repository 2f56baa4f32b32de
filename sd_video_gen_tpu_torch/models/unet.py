"""SD v1 UNet2DCondition in PyTorch, channels-last.

Counterpart of ``sd_video_gen_tpu/models/unet.py``. Parameter names follow
the diffusers checkpoint keys (``down_blocks.0.attentions.0.transformer_blocks
.0.attn1.to_q.weight``, ``ff.net.0.proj`` fused GEGLU, ...). Defaults are the
SD-v1.4 config: block_out_channels (320, 640, 1280, 1280), 2 layers per
block, 8 heads, cross_attention_dim 768, GroupNorm eps 1e-5 (1e-6 in the
Transformer2D input norm), GEGLU feed-forward with exact GELU, flip_sin_to_cos
time features. Spatial self-attention (``attn1``) goes through the flash
kernel on a GPU; cross-attention over the text context stays plain. Every
GroupNorm (+ SiLU) goes through the GroupNorm kernel on a GPU (the
``nn.GroupNorm`` modules only hold its parameters).

Layout: logical shapes are (B, C, H, W); the memory format is
``torch.channels_last`` from ``conv_in`` to the output, on the CPU as on the
card (see ``models/vae.py``): the skip concatenation, the time-embedding
add, nearest upsampling and the 1x1 projections keep it, and a
``Transformer2D``'s token sequence (B, HW, C) is a view of it both ways.
Nothing on that path may call ``.contiguous()`` without a memory format.

Tensor parallelism: built with ``shard`` (a ``parallel.mesh.ModelShard``
of size > 1), the model holds one rank's slice of every split weight
(``parallel/sharding.py``) and runs the Megatron pairs with the collectives
of ``parallel/constrain.py``: each resnet's ``conv1`` and ``time_emb_proj``
make this rank's channels, ``norm2`` normalises them (its groups split with
them, so the GroupNorm kernel runs on the channel shard) and ``conv2``'s
partial sums meet in one all-reduce; each attention layer runs this rank's
heads (the flash kernel on the local (B * heads / size, T, head dim) for
self-attention) and ``to_out.0`` sums them; the GEGLU feed-forward and the
time embedding split their hidden features. Everything else runs whole on
every rank, on the replicated stream. A layer whose split dimension does
not divide the axis stays whole (the JAX rules' divisibility fallback); a
split that would cut a head or a GroupNorm group raises. Without a shard,
or at size 1, the model is the plain one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_video_gen_tpu_torch.ops.attention import attention
from sd_video_gen_tpu_torch.ops.groupnorm import group_norm
from sd_video_gen_tpu_torch.parallel.constrain import (copy_to_model,
                                                       row_parallel)
from sd_video_gen_tpu_torch.parallel.sharding import check_split, splits


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def down_has_attn(self, i: int) -> bool:
        return i < len(self.block_out_channels) - 1

    def up_has_attn(self, i: int) -> bool:
        return i > 0


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal timestep features (diffusers get_timestep_embedding), f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def _width(shard) -> int:
    return shard.size if shard is not None else 1


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, shard=None):
        super().__init__()
        self.shard = shard = splits(shard, dim)
        self.linear_1 = nn.Linear(in_dim, dim // _width(shard))
        self.linear_2 = nn.Linear(dim // _width(shard), dim)

    def forward(self, x):
        if self.shard is None:
            return self.linear_2(F.silu(self.linear_1(x)))
        h = F.silu(self.linear_1(copy_to_model(x, self.shard)))
        return row_parallel(F.linear(h, self.linear_2.weight),
                            self.linear_2.bias, self.shard)


class ResnetBlock2D(nn.Module):
    """Resnet block with timestep-embedding injection."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int,
                 shard=None):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.shard = shard = splits(shard, out_ch)
        check_split(shard, f"resnet of {out_ch} channels", g, "group")
        w = _width(shard)
        self.norm1 = nn.GroupNorm(g, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch // w, 3, padding=1)
        self.time_emb_proj = nn.Linear(cfg.time_embed_dim, out_ch // w)
        self.norm2 = nn.GroupNorm(g // w, out_ch // w, eps=eps)
        self.conv2 = nn.Conv2d(out_ch // w, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = group_norm(self.norm1, x, silu=True)
        if self.shard is not None:
            h, temb = (copy_to_model(t, self.shard) for t in (h, temb))
        h = self.conv1(h)
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = group_norm(self.norm2, h, silu=True)
        if self.shard is None:
            h = self.conv2(h)
        else:
            h = row_parallel(self.conv2._conv_forward(h, self.conv2.weight,
                                                      None),
                             self.conv2.bias, self.shard)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention; context=None -> spatial self-attention."""

    def __init__(self, query_dim: int, heads: int,
                 context_dim: int | None = None, shard=None):
        super().__init__()
        ctx = context_dim or query_dim
        self.shard = shard = splits(shard, query_dim)
        check_split(shard, f"attention of width {query_dim}", heads, "head")
        w = _width(shard)
        self.heads = heads // w               # this rank's
        self.to_q = nn.Linear(query_dim, query_dim // w, bias=False)
        self.to_k = nn.Linear(ctx, query_dim // w, bias=False)
        self.to_v = nn.Linear(ctx, query_dim // w, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim // w, query_dim)])

    def forward(self, x, context=None):
        if self.shard is not None:
            x = copy_to_model(x, self.shard)
            if context is not None:
                context = copy_to_model(context, self.shard)
        ctx = x if context is None else context
        B, Tq, _ = x.shape
        C = self.to_q.out_features            # this rank's heads' width
        H, hd = self.heads, C // self.heads

        def heads(t):  # (B, T, C) -> (B*H, T, hd), contiguous
            # This layer's one layout copy, made here where it can be seen:
            # ``attention`` copies nothing and its kernel takes contiguous
            # tensors. At B > 1 the reshape after the transpose copies and
            # ``contiguous`` is a no-op; at B = 1 the reshape is a view
            # (heads strided over the token rows) and ``contiguous`` copies.
            t = t.reshape(B, -1, H, hd).transpose(1, 2).reshape(B * H, -1, hd)
            return t.contiguous()

        o = attention(heads(self.to_q(x)), heads(self.to_k(ctx)),
                      heads(self.to_v(ctx)), scale=hd ** -0.5)
        o = o.reshape(B, H, Tq, hd).transpose(1, 2).reshape(B, Tq, C)
        if self.shard is None:
            return self.to_out[0](o)
        return row_parallel(F.linear(o, self.to_out[0].weight),
                            self.to_out[0].bias, self.shard)


class GEGLU(nn.Module):
    """Fused h|gate projection (diffusers ``ff.net.0``): h * gelu(gate)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, shard=None):
        super().__init__()
        self.shard = shard = splits(shard, 4 * dim)
        w = _width(shard)
        # keys ff.net.0.proj / ff.net.2 (net.1 is a parameter-free dropout);
        # split, ff.net.0.proj holds this rank's h rows, then its gate rows
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim // w), nn.Identity(),
                                  nn.Linear(4 * dim // w, dim)])

    def forward(self, x):
        if self.shard is None:
            for m in self.net:
                x = m(x)
            return x
        h = self.net[0](copy_to_model(x, self.shard))
        return row_parallel(F.linear(h, self.net[2].weight),
                            self.net[2].bias, self.shard)


class BasicTransformerBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, dim: int, shard=None):
        super().__init__()
        H = cfg.attention_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, H, shard=shard)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, H, cfg.cross_attention_dim, shard)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, shard)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer block -> 1x1 proj_out + skip."""

    def __init__(self, cfg: UNetConfig, channels: int, shard=None):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(cfg, channels, shard)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(group_norm(self.norm, x, silu=False))
        h = h.flatten(2).transpose(1, 2)       # (B, HW, C): a view of NHWC
        h = self.transformer_blocks[0](h, context)
        # (B, HW, C) contiguous is (B, C, H, W) channels-last: a view back
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return self.proj_out(h) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNetBlock(nn.Module):
    """One level: resnets with optional attentions, then an optional
    ``downsamplers`` / ``upsamplers`` entry (the diffusers key names)."""

    def __init__(self, resnets, attentions, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DCondition(nn.Module):
    """sample (B, 4, H, W), timesteps (B,), context (B, 77, 768) -> eps (f32).
    ``shard``: this rank's place on the model axis (module docstring)."""

    SHARDING = "unet"      # its rules in parallel/sharding.py

    def __init__(self, cfg: UNetConfig = UNetConfig(), shard=None):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim,
                                                shard)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        down, prev = [], ch[0]
        skip_ch = [ch[0]]
        for i in range(n):
            res, att = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock2D(cfg, prev, ch[i], shard))
                prev = ch[i]
                if cfg.down_has_attn(i):
                    att.append(Transformer2D(cfg, ch[i], shard))
                skip_ch.append(ch[i])
            ds = Downsample2D(ch[i]) if i < n - 1 else None
            if ds is not None:
                skip_ch.append(ch[i])
            down.append(UNetBlock(res, att, downsample=ds))
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = UNetBlock(
            [ResnetBlock2D(cfg, ch[-1], ch[-1], shard),
             ResnetBlock2D(cfg, ch[-1], ch[-1], shard)],
            [Transformer2D(cfg, ch[-1], shard)])

        rev = list(reversed(ch))
        up = []
        for i in range(n):
            res, att = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock2D(cfg, prev + skip_ch.pop(), rev[i],
                                         shard))
                prev = rev[i]
                if cfg.up_has_attn(i):
                    att.append(Transformer2D(cfg, rev[i], shard))
            up.append(UNetBlock(
                res, att, upsample=Upsample2D(rev[i]) if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0],
                                          eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timesteps, context):
        dt = self.dtype
        t_feat = timestep_embedding(timesteps, self.cfg.block_out_channels[0],
                                    self.cfg.flip_sin_to_cos,
                                    self.cfg.freq_shift)
        temb = self.time_embedding(t_feat.to(dt))
        context = context.to(dt)

        x = self.conv_in(sample.to(dt).contiguous(
            memory_format=torch.channels_last))
        skips = [x]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                x = res(x, temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
                skips.append(x)
            for ds in getattr(block, "downsamplers", []):
                x = ds(x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x, context)
        x = mid.resnets[1](x, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
            for us in getattr(block, "upsamplers", []):
                x = us(x)

        x = self.conv_out(group_norm(self.conv_norm_out, x, silu=True))
        return x.float()
