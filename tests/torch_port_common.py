"""Shared pieces of the PyTorch port's CPU tests: tiny JAX models and their
port counterparts, loaded with the same (perturbed, seeded) weights through
the bridge (``sd_video_gen_tpu_torch/diffusion/weights.py``).

The JAX weights are seeded numpy draws shaped by ``jax.eval_shape`` of the
flax init (no init program is compiled). Every leaf is random, biases and
norm scales included, so a weight routed to the wrong place shows.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from sd_video_gen_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                               CLIPTextEncoder as JCLIP)
from sd_video_gen_tpu.models.transformer import (
    FrameTransformer as JFrameTransformer,
    FrameTransformerConfig as JFTConfig)
from sd_video_gen_tpu.models.unet import (UNet2DCondition as JUNet,
                                          UNetConfig as JUNetConfig)
from sd_video_gen_tpu.models.vae import (AutoencoderKL as JVAE,
                                         VAEConfig as JVAEConfig)
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask

from sd_video_gen_tpu_torch.diffusion.weights import load_jax_params
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                     CLIPTextEncoder)
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from torch_replay import ReplayGraphs  # noqa: F401  (the tests' stand-in)

TINY_VAE = dict(block_out_channels=(8, 16), layers_per_block=1,
                norm_num_groups=2)
TINY_UNET = dict(block_out_channels=(8, 16), layers_per_block=1,
                 attention_heads=2, cross_attention_dim=16, norm_num_groups=2)
TINY_CLIP = dict(vocab_size=49408, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_length=8)
TINY_FT = dict(dim_model=32, num_heads=4, num_encoder_layers=1,
               num_decoder_layers=2, dim_feedforward=48)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_params(module, seed: int, *init_args, **init_kw):
    """Seeded weights for a flax module: kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args,
                            **init_kw)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return jnp.asarray(x / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray((1.0 if name == "scale" else 0.0) + 0.1 * x)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def vae_pair(seed: int = 0):
    jm = JVAE(JVAEConfig(**TINY_VAE))
    params = random_params(jm, seed, jnp.zeros((1, 8, 8, 3)))
    pm = load_jax_params(build(AutoencoderKL, VAEConfig(**TINY_VAE), 'cpu'), "vae",
                         np_tree(params))
    return jm, params, pm


def unet_pair(seed: int = 0):
    jm = JUNet(JUNetConfig(**TINY_UNET))
    params = random_params(jm, seed, jnp.zeros((1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 16)))
    pm = load_jax_params(build(UNet2DCondition, UNetConfig(**TINY_UNET), "cpu"),
                         "unet", np_tree(params))
    return jm, params, pm


def clip_pair(seed: int = 0):
    from sd_video_gen_tpu.models.clip_text import empty_prompt_ids
    jm = JCLIP(JCLIPConfig(**TINY_CLIP))
    params = random_params(jm, seed, empty_prompt_ids(1, 8))
    pm = load_jax_params(build(CLIPTextEncoder, CLIPTextConfig(**TINY_CLIP),
                               "cpu"),
                         "clip", np_tree(params))
    return jm, params, pm


def transformer_pair(latent_dim: int, seed: int = 0,
                     pe_mode: str = "timestep", mode: str = "ar", **extra):
    """``extra``: ``frames_to_predict`` / ``text_embed_dim`` / ``max_len``
    for both configs."""
    kw = dict(latent_dim=latent_dim, pe_mode=pe_mode, mode=mode,
              **{**TINY_FT, **extra})
    jm = JFrameTransformer(JFTConfig(dropout_p=0.0, **kw))
    x = jnp.zeros((1, 3, latent_dim))
    text = (jnp.zeros((1, jm.cfg.text_embed_dim)) if mode == "text" else None)
    params = random_params(jm, seed, x, x, tgt_mask=jcausal_mask(3),
                           text_embeds=text)
    pm = load_jax_params(
        build(FrameTransformer, FrameTransformerConfig(**kw), "cpu"),
        "transformer", np_tree(params))
    return jm, params, pm


def sd_pair(frame_size: int, seeds=(20, 21, 22)):
    """The JAX ``SDPipeline`` and the port's over the same tiny VAE, UNet and
    CLIP-text weights."""
    from sd_video_gen_tpu.diffusion.sd import SDPipeline as JSDPipeline
    from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
    _, vparams, pvae = vae_pair(seed=seeds[0])
    _, uparams, punet = unet_pair(seed=seeds[1])
    _, cparams, pclip = clip_pair(seed=seeds[2])
    jpipe = JSDPipeline(frame_size=frame_size, vae_params=vparams,
                        unet_params=uparams, clip_params=cparams,
                        vae_cfg=JVAEConfig(**TINY_VAE),
                        unet_cfg=JUNetConfig(**TINY_UNET),
                        clip_cfg=JCLIPConfig(**TINY_CLIP))
    return jpipe, SDPipeline(pvae, punet, pclip)


def nchw(x):
    """JAX NHWC latents -> the port's (B, C, H, W) CPU tensor."""
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(x: torch.Tensor) -> np.ndarray:
    """The port's (B, C, H, W) latents -> NHWC numpy, as the JAX package's."""
    return x.permute(0, 2, 3, 1).numpy()


def japply(module, params, *args, **kw):
    """``module.apply`` compiled once (op-by-op flax dispatch is slower)."""
    return jax.jit(functools.partial(module.apply, **kw))(params, *args)


def t(x):
    """numpy / jax array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))
