"""Port of models/{vae,unet,clip_text,transformer} and diffusion/vae_codec
against the JAX package on the CPU, with weights moved by the bridge; the
port's VAE and UNet against the committed golden fixtures.

Tolerance: f32 on both sides; convolution and matmul summation orders
differ, so rtol 1e-4 / atol 1e-5 unless stated. Decoded uint8 frames may
differ by one level where a value sits on a rounding boundary.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.diffusion.vae_codec import VAECodec as JVAECodec
from sd_video_gen_tpu.models.clip_text import empty_prompt_ids as jempty_ids
from sd_video_gen_tpu.models.unet import timestep_embedding as jtimestep
from sd_video_gen_tpu.models.vae import AutoencoderKL as JVAE
from sd_video_gen_tpu.models.vae import VAEConfig as JVAEConfig
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models.clip_text import empty_prompt_ids
from sd_video_gen_tpu_torch.models.unet import timestep_embedding
from sd_video_gen_tpu_torch.ops.masks import causal_mask
from torch_port_common import (TINY_VAE, clip_pair, japply, t,
                               transformer_pair, unet_pair, vae_pair)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def vae():
    return vae_pair(seed=0)


def test_vae_encode_decode_match_jax(vae):
    jm, params, pm = vae
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jmean, jlogvar = japply(jm, params, jnp.asarray(x), method=JVAE.encode)
    with torch.no_grad():
        mean, logvar = pm.encode(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(mean.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jmean), **TOL)
    np.testing.assert_allclose(logvar.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jlogvar), **TOL)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jdec = japply(jm, params, jnp.asarray(z), method=JVAE.decode)
    with torch.no_grad():
        dec = pm.decode(t(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(dec.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdec), **TOL)


def test_vae_codec_uint8_round_trip_matches_jax(vae):
    jm, params, pm = vae
    jc = JVAECodec(16, params=params, cfg=JVAEConfig(**TINY_VAE))
    pc = VAECodec(16, pm)
    assert pc.latent_dim == jc.latent_dim == 4 * 8 * 8
    frames = np.random.default_rng(1).integers(
        0, 256, (2, 3, 16, 16, 3)).astype(np.uint8)
    jlat = np.asarray(jax.jit(jc.encode_batch)(jnp.asarray(frames)))
    with torch.no_grad():
        lat = pc.encode_batch(t(frames))
    assert lat.shape == jlat.shape == (2, 4, pc.latent_dim)
    np.testing.assert_allclose(lat.numpy(), jlat, **TOL)
    flat = jlat[:, 1:].reshape(-1, pc.latent_dim)
    jimg = np.asarray(jax.jit(jc.decode_latents)(jnp.asarray(flat)))
    with torch.no_grad():
        img = pc.decode_latents(t(flat))
    assert img.dtype == torch.uint8 and img.shape == jimg.shape
    diff = np.abs(img.numpy().astype(int) - jimg.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_timestep_embedding_matches_jax():
    # atol 1e-4: sin/cos of f32 arguments up to ~999 rad, where one ulp of
    # the argument is 6e-5
    ts = np.array([0, 1, 261, 999], np.float32)
    for flip in (True, False):
        want = jtimestep(jnp.asarray(ts), 320, flip)
        got = timestep_embedding(t(ts), 320, flip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


def test_unet_matches_jax():
    jm, params, pm = unet_pair(seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([981, 1], np.float32)
    ctx = rng.standard_normal((2, 8, 16)).astype(np.float32)
    want = japply(jm, params, jnp.asarray(x), jnp.asarray(ts),
                  jnp.asarray(ctx))
    with torch.no_grad():
        got = pm(t(x).permute(0, 3, 1, 2), t(ts), t(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_clip_text_matches_jax():
    jm, params, pm = clip_pair(seed=2)
    ids = np.random.default_rng(3).integers(0, 49408, (2, 8))
    ids[0] = np.asarray(jempty_ids(1, 8))[0]
    want = japply(jm, params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = pm(t(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(empty_prompt_ids(2, 8).numpy(),
                                  np.asarray(jempty_ids(2, 8)))


@pytest.mark.parametrize("pe_mode", ["timestep", "reference_batch"])
def test_frame_transformer_matches_jax(pe_mode):
    L = 24
    jm, params, pm = transformer_pair(L, seed=3, pe_mode=pe_mode)
    rng = np.random.default_rng(4)
    src = rng.standard_normal((3, 6, L)).astype(np.float32)
    tgt = rng.standard_normal((3, 5, L)).astype(np.float32)
    want = japply(jm, params, jnp.asarray(src), jnp.asarray(tgt),
                  tgt_mask=jcausal_mask(5))
    with torch.no_grad():
        got = pm(t(src), t(tgt), tgt_mask=causal_mask(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(causal_mask(5).numpy(),
                                  np.asarray(jcausal_mask(5)))


def _golden(name):
    fx = dict(np.load(os.path.join(FIXDIR, name)))
    sd = {k[3:]: v for k, v in fx.items() if k.startswith("sd/")}
    return fx, sd


def test_vae_golden_forward_via_bridge():
    from sd_video_gen_tpu.diffusion.weights import convert_vae
    from sd_video_gen_tpu_torch.diffusion.weights import load_jax_params
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    fx, sd = _golden("vae_golden.npz")
    blocks = tuple(int(b) for b in fx["meta/blocks"])
    layers = int(fx["meta/layers"])
    cfg = VAEConfig(block_out_channels=blocks, layers_per_block=layers,
                    norm_num_groups=int(fx["meta/groups"]),
                    latent_channels=int(fx["meta/latent"]))
    params = jax.tree.map(np.asarray, convert_vae(
        sd, block_out=blocks, layers_per_block=layers))
    vae = load_jax_params(build(AutoencoderKL, cfg), "vae", params)
    # the port's names are the checkpoint's: the bridged weights are its own
    for k, v in vae.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].reshape(v.shape))
    with torch.no_grad():
        mean, _ = vae.encode(t(fx["in/x"]))
        dec = vae.decode(t(fx["in/z"]))
    np.testing.assert_allclose(mean.numpy(), fx["out/enc_mean"],
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(dec.numpy(), fx["out/dec"],
                               rtol=3e-4, atol=3e-5)


def test_unet_golden_forward_via_bridge():
    from sd_video_gen_tpu.diffusion.weights import convert_unet
    from sd_video_gen_tpu_torch.diffusion.weights import load_jax_params
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    fx, sd = _golden("unet_golden.npz")
    blocks = tuple(int(b) for b in fx["meta/blocks"])
    layers = int(fx["meta/layers"])
    cfg = UNetConfig(block_out_channels=blocks, layers_per_block=layers,
                     attention_heads=int(fx["meta/heads"]),
                     cross_attention_dim=int(fx["meta/ctx_dim"]),
                     norm_num_groups=int(fx["meta/groups"]))
    params = jax.tree.map(np.asarray, convert_unet(
        sd, block_out=blocks, layers_per_block=layers))
    unet = load_jax_params(build(UNet2DCondition, cfg), "unet", params)
    for k, v in unet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].reshape(v.shape))
    with torch.no_grad():
        eps = unet(t(fx["in/x"]), t(fx["in/t"]).float(), t(fx["in/ctx"]))
    np.testing.assert_allclose(eps.numpy(), fx["out/eps"],
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("name", ["unet", "vae", "clip", "transformer"])
def test_full_width_parameter_counts(name):
    """SD-v1.4 published counts (as the JAX package's); the flagship
    FrameTransformer's against the JAX module's. Built on the meta device:
    no memory is allocated."""
    from sd_video_gen_tpu.models.transformer import (
        FrameTransformer as JFT, FrameTransformerConfig as JFTConfig)
    from sd_video_gen_tpu_torch.models.clip_text import CLIPTextEncoder
    from sd_video_gen_tpu_torch.models.transformer import (
        FrameTransformer, FrameTransformerConfig)
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL
    if name == "transformer":
        x = jnp.zeros((1, 6, 256))
        shapes = jax.eval_shape(JFT(JFTConfig(latent_dim=256)).init,
                                jax.random.PRNGKey(0), x, x)
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    else:
        want = {"unet": 859_520_964, "vae": 83_653_863,
                "clip": 123_060_480}[name]
    make = {"unet": UNet2DCondition, "vae": AutoencoderKL,
            "clip": CLIPTextEncoder,
            "transformer": lambda: FrameTransformer(
                FrameTransformerConfig(latent_dim=256))}[name]
    with torch.device("meta"):
        model = make()
    assert sum(p.numel() for p in model.parameters()) == want
