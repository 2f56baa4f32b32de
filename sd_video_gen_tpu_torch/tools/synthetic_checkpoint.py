"""Full-size synthetic SD-v1.4 state dicts with the published key names and
shapes, drawn by numpy from a seed (``tools/synthetic_checkpoint.py`` beside
the JAX package; the port keeps its own copy of what it uses, and the same
vintage, dtype and seed give the same arrays bit for bit).

  SD-v1.4 AutoencoderKL         ``vae_state_dict``: 248 tensors, 83.65M
  SD-v1.4 UNet2DConditionModel  ``unet_state_dict``: 686 tensors, 859.52M

so the weight-file converters (``diffusion/weights.py``) can be exercised at
full size, every key consumed and every parameter filled, without the
published files. Two VAE naming vintages: ``'0.2.3'`` (query / key / value /
proj_attn) and ``'modern'`` (to_q / to_k / to_v / to_out.0).

    python -m sd_video_gen_tpu_torch.tools.synthetic_checkpoint DIR

writes ``DIR/vae.pt`` (modern names, seed 0) and ``DIR/unet.pt`` (seed 1) in
fp16, the files ``chip_smoke.py`` loads.
"""

from __future__ import annotations

import sys

import numpy as np

VAE_BLOCK_OUT = (128, 256, 512, 512)
UNET_BLOCK_OUT = (320, 640, 1280, 1280)
CROSS_DIM = 768
TIME_DIM = 1280
LATENT_CH = 4


def _fill(shape, dtype, rng, scale):
    if rng is None:
        return np.zeros(shape, dtype)
    n = int(np.prod(shape))
    return (rng.standard_normal(n).astype(dtype) * scale).reshape(shape)


class _Builder:
    def __init__(self, dtype=np.float32, seed=None):
        self.sd: dict[str, np.ndarray] = {}
        self.dtype = dtype
        self.rng = np.random.default_rng(seed) if seed is not None else None

    def add(self, name, *shape, scale=0.02):
        if name in self.sd:
            raise KeyError(f"duplicate key {name}")
        self.sd[name] = _fill(shape, self.dtype, self.rng, scale)

    def norm(self, prefix, ch):
        # norm scale ~1 keeps activations finite in forward rehearsals
        if self.rng is None:
            self.sd[prefix + ".weight"] = np.ones(ch, self.dtype)
        else:
            self.add(prefix + ".weight", ch, scale=0.02)
            self.sd[prefix + ".weight"] += 1.0
        self.add(prefix + ".bias", ch)
        return self

    def conv(self, prefix, out_c, in_c, k=3):
        self.add(prefix + ".weight", out_c, in_c, k, k)
        self.add(prefix + ".bias", out_c)
        return self

    def linear(self, prefix, out_c, in_c, bias=True):
        self.add(prefix + ".weight", out_c, in_c)
        if bias:
            self.add(prefix + ".bias", out_c)
        return self


def _resnet(b: _Builder, p: str, in_c: int, out_c: int, time_emb: bool):
    b.norm(p + ".norm1", in_c)
    b.conv(p + ".conv1", out_c, in_c)
    if time_emb:
        b.linear(p + ".time_emb_proj", out_c, TIME_DIM)
    b.norm(p + ".norm2", out_c)
    b.conv(p + ".conv2", out_c, out_c)
    if in_c != out_c:
        b.conv(p + ".conv_shortcut", out_c, in_c, k=1)


def _vae_attn(b: _Builder, p: str, ch: int, vintage: str):
    b.norm(p + ".group_norm", ch)
    names = (("query", "key", "value", "proj_attn") if vintage == "0.2.3"
             else ("to_q", "to_k", "to_v", "to_out.0"))
    for n in names:
        b.linear(f"{p}.{n}", ch, ch)


def vae_state_dict(vintage: str = "0.2.3", dtype=np.float32,
                   seed=None) -> dict:
    """SD-v1.4 AutoencoderKL state dict: 248 tensors, 83.65M params."""
    if vintage not in ("0.2.3", "modern"):
        raise ValueError(f"unknown VAE naming vintage {vintage!r}")
    b = _Builder(dtype, seed)
    bo = VAE_BLOCK_OUT

    b.conv("encoder.conv_in", bo[0], 3)
    in_c = bo[0]
    for i, out_c in enumerate(bo):
        for j in range(2):
            _resnet(b, f"encoder.down_blocks.{i}.resnets.{j}",
                    in_c if j == 0 else out_c, out_c, time_emb=False)
        if i < len(bo) - 1:
            b.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                   out_c, out_c)
        in_c = out_c
    mid = bo[-1]
    _resnet(b, "encoder.mid_block.resnets.0", mid, mid, False)
    _vae_attn(b, "encoder.mid_block.attentions.0", mid, vintage)
    _resnet(b, "encoder.mid_block.resnets.1", mid, mid, False)
    b.norm("encoder.conv_norm_out", mid)
    b.conv("encoder.conv_out", 2 * LATENT_CH, mid)
    b.conv("quant_conv", 2 * LATENT_CH, 2 * LATENT_CH, k=1)
    b.conv("post_quant_conv", LATENT_CH, LATENT_CH, k=1)

    b.conv("decoder.conv_in", mid, LATENT_CH)
    _resnet(b, "decoder.mid_block.resnets.0", mid, mid, False)
    _vae_attn(b, "decoder.mid_block.attentions.0", mid, vintage)
    _resnet(b, "decoder.mid_block.resnets.1", mid, mid, False)
    rev = list(reversed(bo))  # (512, 512, 256, 128)
    in_c = rev[0]
    for i, out_c in enumerate(rev):
        for j in range(3):
            _resnet(b, f"decoder.up_blocks.{i}.resnets.{j}",
                    in_c if j == 0 else out_c, out_c, time_emb=False)
        if i < len(rev) - 1:
            b.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out_c, out_c)
        in_c = out_c
    b.norm("decoder.conv_norm_out", rev[-1])
    b.conv("decoder.conv_out", 3, rev[-1])
    return b.sd


def _tf2d(b: _Builder, p: str, ch: int):
    """SD-1.x Transformer2DModel: 1x1-conv proj_in / proj_out, one
    BasicTransformerBlock."""
    b.norm(p + ".norm", ch)
    b.conv(p + ".proj_in", ch, ch, k=1)
    blk = p + ".transformer_blocks.0"
    for attn, kv in (("attn1", ch), ("attn2", CROSS_DIM)):
        b.linear(f"{blk}.{attn}.to_q", ch, ch, bias=False)
        b.linear(f"{blk}.{attn}.to_k", ch, kv, bias=False)
        b.linear(f"{blk}.{attn}.to_v", ch, kv, bias=False)
        b.linear(f"{blk}.{attn}.to_out.0", ch, ch)
    b.linear(blk + ".ff.net.0.proj", 8 * ch, ch)  # GEGLU: 2 * (4*ch)
    b.linear(blk + ".ff.net.2", ch, 4 * ch)
    for n in ("norm1", "norm2", "norm3"):
        b.norm(f"{blk}.{n}", ch)
    b.conv(p + ".proj_out", ch, ch, k=1)


def unet_state_dict(dtype=np.float32, seed=None) -> dict:
    """SD-v1.4 UNet2DConditionModel state dict: 686 tensors, 859.52M params."""
    b = _Builder(dtype, seed)
    bo = UNET_BLOCK_OUT
    n = len(bo)

    b.conv("conv_in", bo[0], LATENT_CH)
    b.linear("time_embedding.linear_1", TIME_DIM, bo[0])
    b.linear("time_embedding.linear_2", TIME_DIM, TIME_DIM)

    in_c = bo[0]
    for i, out_c in enumerate(bo):
        for j in range(2):
            _resnet(b, f"down_blocks.{i}.resnets.{j}",
                    in_c if j == 0 else out_c, out_c, time_emb=True)
            if i < n - 1:
                _tf2d(b, f"down_blocks.{i}.attentions.{j}", out_c)
        if i < n - 1:
            b.conv(f"down_blocks.{i}.downsamplers.0.conv", out_c, out_c)
        in_c = out_c

    mid = bo[-1]
    _resnet(b, "mid_block.resnets.0", mid, mid, True)
    _tf2d(b, "mid_block.attentions.0", mid)
    _resnet(b, "mid_block.resnets.1", mid, mid, True)

    # up path: diffusers UNet2DConditionModel skip-channel arithmetic
    rev = list(reversed(bo))  # (1280, 1280, 640, 320)
    prev_out = rev[0]
    for i, out_c in enumerate(rev):
        skip_in = rev[min(i + 1, n - 1)]
        for j in range(3):
            res_skip = skip_in if j == 2 else out_c
            res_in = prev_out if j == 0 else out_c
            _resnet(b, f"up_blocks.{i}.resnets.{j}",
                    res_in + res_skip, out_c, time_emb=True)
            if i > 0:
                _tf2d(b, f"up_blocks.{i}.attentions.{j}", out_c)
        if i < n - 1:
            b.conv(f"up_blocks.{i}.upsamplers.0.conv", out_c, out_c)
        prev_out = out_c

    b.norm("conv_norm_out", bo[0])
    b.conv("conv_out", LATENT_CH, bo[0])
    return b.sd


def write_sd_files(out_dir: str) -> None:
    """``out_dir/vae.pt`` and ``out_dir/unet.pt``: the modern-vintage VAE
    (seed 0) and the UNet (seed 1) in fp16, as torch state dicts."""
    import torch
    for name, make in (("vae", lambda: vae_state_dict("modern", np.float16,
                                                       0)),
                       ("unet", lambda: unet_state_dict(np.float16, 1))):
        torch.save({k: torch.from_numpy(v) for k, v in make().items()},
                   f"{out_dir}/{name}.pt")


if __name__ == "__main__":
    write_sd_files(sys.argv[1])
