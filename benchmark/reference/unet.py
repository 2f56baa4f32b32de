"""The SD v1.4 UNet2DCondition, plain.

block_out_channels (320, 640, 1280, 1280), two layers a block, 8 heads,
cross-attention to 768-wide text states, GroupNorm eps 1e-5 (1e-6 in a
Transformer2D's input norm), GEGLU feed-forward with exact GELU,
flip_sin_to_cos time features. Parameter names are the diffusers keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import attention, group_norm


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

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.norm1 = nn.GroupNorm(g, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(cfg.time_embed_dim, out_ch)
        self.norm2 = nn.GroupNorm(g, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.conv1(group_norm(self.norm1, x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(group_norm(self.norm2, h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, context_dim=None):
        super().__init__()
        ctx = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        B, Tq, C = x.shape
        H, hd = self.heads, C // self.heads

        def heads(t):
            return t.reshape(B, -1, H, hd).transpose(1, 2).reshape(B * H, -1,
                                                                   hd)

        o = attention(heads(self.to_q(x)), heads(self.to_k(ctx)),
                      heads(self.to_v(ctx)), hd ** -0.5)
        o = o.reshape(B, H, Tq, hd).transpose(1, 2).reshape(B, Tq, C)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, dim: int):
        super().__init__()
        H = cfg.attention_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, H)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, H, cfg.cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(cfg, channels)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(group_norm(self.norm, x, silu=False))
        h = self.transformer_blocks[0](h.flatten(2).transpose(1, 2), context)
        return self.proj_out(h.transpose(1, 2).reshape(B, C, H, W)) + x


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
    def __init__(self, resnets, attentions, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DCondition(nn.Module):
    """sample (B, 4, H, W), timesteps (B,), context (B, 77, 768) -> eps."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        down, prev, skip_ch = [], ch[0], [ch[0]]
        for i in range(n):
            res, att = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock2D(cfg, prev, ch[i]))
                prev = ch[i]
                if i < n - 1:
                    att.append(Transformer2D(cfg, ch[i]))
                skip_ch.append(ch[i])
            ds = Downsample2D(ch[i]) if i < n - 1 else None
            if ds is not None:
                skip_ch.append(ch[i])
            down.append(UNetBlock(res, att, downsample=ds))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = UNetBlock(
            [ResnetBlock2D(cfg, ch[-1], ch[-1]),
             ResnetBlock2D(cfg, ch[-1], ch[-1])],
            [Transformer2D(cfg, ch[-1])])
        rev, up = list(reversed(ch)), []
        for i in range(n):
            res, att = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock2D(cfg, prev + skip_ch.pop(), rev[i]))
                prev = rev[i]
                if i > 0:
                    att.append(Transformer2D(cfg, rev[i]))
            up.append(UNetBlock(
                res, att, upsample=Upsample2D(rev[i]) if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0],
                                          eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context):
        temb = self.time_embedding(timestep_embedding(
            timesteps, self.cfg.block_out_channels[0]).to(sample.dtype))
        x = self.conv_in(sample)
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
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb),
                                             context), temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
            for us in getattr(block, "upsamplers", []):
                x = us(x)
        return self.conv_out(group_norm(self.conv_norm_out, x, silu=True))
