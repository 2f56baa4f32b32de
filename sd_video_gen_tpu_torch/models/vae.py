"""Stable Diffusion v1.4 VAE (AutoencoderKL) in PyTorch, channels-last.

Counterpart of ``sd_video_gen_tpu/models/vae.py``. Parameter names follow the
diffusers checkpoint keys (``encoder.down_blocks.0.resnets.0.norm1.weight``,
``encoder.mid_block.attentions.0.query.weight``, ...). Architecture:
GroupNorm(32, eps 1e-6) + SiLU resnet blocks; a single-head mid-block
self-attention over H*W tokens that goes through the flash kernel on a GPU;
every GroupNorm (+ SiLU) goes through the GroupNorm kernel on a GPU (the
``nn.GroupNorm`` modules only hold its parameters);
stride-2 downsampling after a (0, 1, 0, 1) pad; nearest x2 upsampling.
Defaults are SD-v1 AutoencoderKL: block_out_channels (128, 256, 512, 512),
2 layers per block, 4 latent channels.

Layout: logical shapes are (B, C, H, W) everywhere; the memory format is
``torch.channels_last`` from the first convolution of ``encode`` / ``decode``
to the output, on the CPU as on the card, so cuDNN's NHWC convolutions, the
GroupNorm kernel's NHWC body and the attention block's token view all work on
one layout with no copy between them. Nothing on that path may call
``.contiguous()`` without a memory format.

Tensor parallelism (``shard``, as in ``models/unet.py``): each resnet's
``conv1`` makes this rank's channels, ``norm2`` normalises them on the
channel shard and ``conv2``'s partial sums meet in one all-reduce; the
attention block's ``query/key/value`` make this rank's feature slice of its
single head, ``ops/attention.sharded_attention`` runs the head by batch,
ring or gathered features, and ``proj_attn`` sums the slices. Everything
else runs whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_video_gen_tpu_torch.ops.attention import attention, sharded_attention
from sd_video_gen_tpu_torch.ops.groupnorm import group_norm
from sd_video_gen_tpu_torch.parallel.constrain import (copy_to_model,
                                                       row_parallel)
from sd_video_gen_tpu_torch.parallel.sharding import check_split, splits


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
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, shard=None):
        super().__init__()
        self.shard = shard = splits(shard, out_ch)
        g = cfg.norm_num_groups
        check_split(shard, f"resnet of {out_ch} channels", g, "group")
        w = shard.size if shard is not None else 1
        self.norm1 = _gn(cfg, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch // w, 3, padding=1)
        self.norm2 = nn.GroupNorm(g // w, out_ch // w, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch // w, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = group_norm(self.norm1, x, silu=True)
        if self.shard is None:
            h = self.conv2(group_norm(self.norm2, self.conv1(h), silu=True))
        else:
            h = self.conv1(copy_to_model(h, self.shard))
            h = group_norm(self.norm2, h, silu=True)
            h = row_parallel(self.conv2._conv_forward(h, self.conv2.weight,
                                                      None),
                             self.conv2.bias, self.shard)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over (H*W) tokens."""

    def __init__(self, cfg: VAEConfig, channels: int, shard=None):
        super().__init__()
        self.shard = shard = splits(shard, channels)
        c = channels // (shard.size if shard is not None else 1)
        self.group_norm = _gn(cfg, channels)
        self.query = nn.Linear(channels, c)
        self.key = nn.Linear(channels, c)
        self.value = nn.Linear(channels, c)
        self.proj_attn = nn.Linear(c, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = group_norm(self.group_norm, x, silu=False)
        h = h.flatten(2).transpose(1, 2)       # (B, HW, C): a view of NHWC
        if self.shard is not None:
            h = copy_to_model(h, self.shard)
        # three fresh contiguous (B, HW, C) tensors: no copy before attention
        q, k, v = self.query(h), self.key(h), self.value(h)
        if self.shard is None:
            h = self.proj_attn(attention(q, k, v, scale=C ** -0.5))
        else:
            h = row_parallel(F.linear(sharded_attention(
                q, k, v, C ** -0.5, self.shard), self.proj_attn.weight),
                self.proj_attn.bias, self.shard)
        # (B, HW, C) contiguous is (B, C, H, W) channels-last: a view back
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        # one row/col at the bottom/right, then a VALID stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, channels: int, shard=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cfg, channels, channels, shard),
             ResnetBlock(cfg, channels, channels, shard)])
        self.attentions = nn.ModuleList([AttnBlock(cfg, channels, shard)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VAEBlock(nn.Module):
    """One level: resnets, then (except the last level) a ``downsamplers``
    (encoder) or ``upsamplers`` (decoder) entry, as diffusers names them."""

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
    def __init__(self, cfg: VAEConfig, shard=None):
        super().__init__()
        ch = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, prev = [], ch[0]
        for i, out_ch in enumerate(ch):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock(cfg, prev, out_ch, shard))
                prev = out_ch
            blocks.append(VAEBlock(
                res, downsample=Downsample(out_ch) if i < len(ch) - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(cfg, ch[-1], shard)
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
    def __init__(self, cfg: VAEConfig, shard=None):
        super().__init__()
        ch = list(reversed(cfg.block_out_channels))   # (512, 512, 256, 128)
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlock(cfg, ch[0], shard)
        blocks, prev = [], ch[0]
        for i, out_ch in enumerate(ch):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(cfg, prev, out_ch, shard))
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
    """encode -> (mean, logvar); decode(latents) -> pixels in [-1, 1].
    (B, C, H, W) in and out; inputs of any strides, outputs channels-last.
    ``shard``: this rank's place on the model axis (module docstring)."""

    SHARDING = "vae"       # its rules in parallel/sharding.py

    def __init__(self, cfg: VAEConfig = VAEConfig(), shard=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, shard)
        self.decoder = Decoder(cfg, shard)
        lc = cfg.latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x):
        """(B, 3, H, W) pixels in [-1, 1] -> (mean, logvar), (B, 4, H/8, W/8)."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        z = z.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, generator=None, sample: bool = False, noise=None):
        """(decode(z), mean, logvar): z is the posterior mean, or with
        ``sample`` a draw from the posterior (``sample_latent``)."""
        mean, logvar = self.encode(x)
        z = (sample_latent(mean, logvar, generator, noise) if sample
             else mean)
        return self.decode(z), mean, logvar


def sample_latent(mean, logvar, generator=None, noise=None):
    """Reparameterised draw from the diagonal gaussian posterior (the
    reference's ``latent_dists.sample()``): ``mean + exp(logvar / 2) *
    noise``, the noise ``noise`` (mean's shape) or a standard normal draw
    from ``generator`` (torch's default generator when None)."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean)
