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


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """Resnet block with timestep-embedding injection."""

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
    """Multi-head attention; context=None -> spatial self-attention."""

    def __init__(self, query_dim: int, heads: int, context_dim: int | None = None):
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
        return self.to_out[0](o)


class GEGLU(nn.Module):
    """Fused h|gate projection (diffusers ``ff.net.0``): h * gelu(gate)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # keys ff.net.0.proj / ff.net.2 (net.1 is a parameter-free dropout)
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
    """GroupNorm -> 1x1 proj_in -> transformer block -> 1x1 proj_out + skip."""

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
    """sample (B, 4, H, W), timesteps (B,), context (B, 77, 768) -> eps (f32)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        down, prev = [], ch[0]
        skip_ch = [ch[0]]
        for i in range(n):
            res, att = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock2D(cfg, prev, ch[i]))
                prev = ch[i]
                if cfg.down_has_attn(i):
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

        rev = list(reversed(ch))
        up = []
        for i in range(n):
            res, att = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock2D(cfg, prev + skip_ch.pop(), rev[i]))
                prev = rev[i]
                if cfg.up_has_attn(i):
                    att.append(Transformer2D(cfg, rev[i]))
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
