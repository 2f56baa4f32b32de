"""The Stable Diffusion v1.4 VAE (AutoencoderKL), plain.

GroupNorm(32, eps 1e-6) + SiLU resnet blocks, a single-head mid-block
self-attention over H*W tokens, stride-2 downsampling after a (0, 1, 0, 1)
pad, nearest x2 upsampling; block_out_channels (128, 256, 512, 512), two
layers a block, 4 latent channels. Parameter names are the diffusers keys.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import attention, group_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32


def _gn(cfg: VAEConfig, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(cfg, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(cfg, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(group_norm(self.norm1, x, silu=True))
        h = self.conv2(group_norm(self.norm2, h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, channels: int):
        super().__init__()
        self.group_norm = _gn(cfg, channels)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = group_norm(self.group_norm, x, silu=False)
        h = h.flatten(2).transpose(1, 2)
        h = self.proj_attn(attention(self.query(h), self.key(h),
                                     self.value(h), C ** -0.5))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, channels, channels),
                                      ResnetBlock(cfg, channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(cfg, channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEBlock(nn.Module):
    def __init__(self, resnets, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def forward(self, x):
        for m in [*self.resnets, *getattr(self, "downsamplers", []),
                  *getattr(self, "upsamplers", [])]:
            x = m(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, prev = [], ch[0]
        for i, out_ch in enumerate(ch):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock(cfg, prev, out_ch))
                prev = out_ch
            down = Downsample(out_ch) if i < len(ch) - 1 else None
            blocks.append(VAEBlock(res, downsample=down))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(cfg, ch[-1])
        self.conv_norm_out = _gn(cfg, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(group_norm(self.conv_norm_out, x, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlock(cfg, ch[0])
        blocks, prev = [], ch[0]
        for i, out_ch in enumerate(ch):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(cfg, prev, out_ch))
                prev = out_ch
            blocks.append(VAEBlock(
                res, upsample=Upsample(out_ch) if i < len(ch) - 1 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _gn(cfg, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(group_norm(self.conv_norm_out, x, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = cfg.latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    @property
    def factor(self) -> int:
        """Pixels a latent cell spans along each side."""
        return 2 ** (len(self.cfg.block_out_channels) - 1)

    def encode_mean(self, x):
        """(B, 3, H, W) pixels in [-1, 1] -> the posterior mean."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
