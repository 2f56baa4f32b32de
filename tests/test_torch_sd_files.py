"""The posterior sample and the file constructors of the port's SD VAE and
pipeline against the JAX package, on the CPU at tiny widths:
``models/vae.sample_latent`` and ``AutoencoderKL(..., sample=True)``,
``VAECodec.encode_frames`` / ``encode_batch`` with a draw,
``VAECodec.from_checkpoint`` and ``SDPipeline.from_pretrained_dir`` (the
diffusers directory layout).

JAX's draws come from its own keys, which torch cannot reproduce: the JAX
side's normal draw is handed to the port as ``noise``. The files are read by
both packages (the JAX package's converters at the tiny widths, since its
constructors assume SD-v1.4's); f32 on both sides, other summation orders:
rtol 1e-4 / atol 1e-5 (the weight-file tests' bound); uint8 frames at most
one level apart.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.diffusion import weights as JW
from sd_video_gen_tpu.diffusion.sd import SDPipeline as JSDPipeline
from sd_video_gen_tpu.diffusion.vae_codec import VAECodec as JVAECodec
from sd_video_gen_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from sd_video_gen_tpu.models.unet import UNetConfig as JUNetConfig
from sd_video_gen_tpu.models.vae import (VAEConfig as JVAEConfig,
                                         sample_latent as jsample_latent)
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models.clip_text import CLIPTextConfig
from sd_video_gen_tpu_torch.models.unet import UNetConfig
from sd_video_gen_tpu_torch.models.vae import VAEConfig, sample_latent
from torch_port_common import (TINY_CLIP, TINY_UNET, TINY_VAE, clip_pair,
                               japply, nchw, nhwc, t, unet_pair, vae_pair)

TOL = dict(rtol=1e-4, atol=1e-5)
SIZE = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vae():
    return vae_pair(seed=30)


def _pixels(seed, shape=(2, SIZE, SIZE, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _frames(seed, batch=2, frames=3):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, frames, SIZE, SIZE, 3), dtype=np.uint8)


def test_sample_latent_matches_jax():
    rng = np.random.default_rng(31)
    mean = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    logvar = rng.uniform(-3, 1, (2, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jsample_latent(jnp.asarray(mean), jnp.asarray(logvar), key)
    noise = jax.random.normal(key, mean.shape, jnp.float32)
    got = sample_latent(nchw(mean), nchw(logvar), noise=nchw(noise))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    # without noise: a draw from the generator, mean + std * N(0, 1)
    g = torch.Generator().manual_seed(0)
    drawn = sample_latent(nchw(mean), nchw(logvar), generator=g)
    z = (drawn - nchw(mean)) / torch.exp(0.5 * nchw(logvar))
    assert abs(z.mean().item()) < 0.2 and abs(z.std().item() - 1) < 0.2


def test_autoencoder_call_with_a_sample_matches_jax(vae):
    jm, params, pm = vae
    x = _pixels(32)
    key = jax.random.PRNGKey(4)
    jdec, jmean, jlogvar = japply(jm, params, jnp.asarray(x), rng=key,
                                  sample=True)
    noise = jax.random.normal(key, jmean.shape, jmean.dtype)
    with torch.no_grad():
        dec, mean, logvar = pm(t(x).permute(0, 3, 1, 2), sample=True,
                               noise=nchw(noise))
        plain, mean0, _ = pm(t(x).permute(0, 3, 1, 2))
        direct = pm.decode(mean0)
    np.testing.assert_allclose(nhwc(mean), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(nhwc(logvar), np.asarray(jlogvar), **TOL)
    np.testing.assert_allclose(nhwc(dec), np.asarray(jdec), **TOL)
    # sample=False decodes the posterior mean
    assert torch.equal(plain, direct)


def test_vae_codec_encode_with_a_draw_matches_jax(vae):
    jm, params, pm = vae
    frames = _frames(33)
    key = jax.random.PRNGKey(5)
    jcodec = JVAECodec(SIZE, params=params, cfg=JVAEConfig(**TINY_VAE))
    want = jcodec.encode_batch(jnp.asarray(frames), use_sos=True, rng=key)
    N = frames.shape[0] * frames.shape[1]
    noise = jax.random.normal(key, (N, 8, 8, 4), jnp.float32)
    codec = VAECodec(SIZE, pm)
    with torch.no_grad():
        got = codec.encode_batch(t(frames), use_sos=True, noise=nchw(noise))
        mean = codec.encode_batch(t(frames))
        g = lambda: torch.Generator().manual_seed(9)
        a = codec.encode_frames(t(frames), generator=g())
        b = codec.encode_frames(t(frames), generator=g())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not torch.allclose(got, mean, atol=1e-3)
    assert torch.equal(a, b) and not torch.allclose(a, mean[:, 1:],
                                                    atol=1e-3)


def test_vae_codec_from_checkpoint_matches_jax(tmp_path, vae):
    _, _, src = vae
    path = str(tmp_path / "vae.safetensors")
    from safetensors.torch import save_file
    save_file({k: v.contiguous() for k, v in src.state_dict().items()}, path)
    codec = VAECodec.from_checkpoint(SIZE, path, device="cpu",
                                     cfg=VAEConfig(**TINY_VAE))
    jcodec = JVAECodec(SIZE, params=JW.convert_exhaustive(
        "vae", JW.load_state_dict(path), block_out=(8, 16),
        layers_per_block=1), cfg=JVAEConfig(**TINY_VAE))
    frames = _frames(34)
    with torch.no_grad():
        lat = codec.encode_frames(t(frames))
        img = codec.decode_latents(lat.reshape(-1, codec.latent_dim))
    want = jcodec.encode_frames(jnp.asarray(frames))
    np.testing.assert_allclose(lat.numpy(), np.asarray(want), **TOL)
    jimg = np.asarray(jcodec.decode_latents(
        jnp.asarray(lat.reshape(-1, codec.latent_dim).numpy())))
    assert np.abs(img.numpy().astype(int) - jimg.astype(int)).max() <= 1
    assert codec.device == torch.device("cpu")


def _diffusers_dir(root, vae, unet, clip, tokenizer=False):
    """A diffusers model directory of the three modules: the VAE as
    safetensors, the UNet as a ``torch.save`` ``.bin``, the text encoder
    with ``transformers``' ``text_model.`` prefix."""
    from safetensors.torch import save_file
    for sub in ("vae", "unet", "text_encoder"):
        os.makedirs(os.path.join(root, sub))
    save_file({k: v.contiguous() for k, v in vae.state_dict().items()},
              os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"))
    torch.save(unet.state_dict(),
               os.path.join(root, "unet", "diffusion_pytorch_model.bin"))
    save_file({"text_model." + k: v.contiguous()
               for k, v in clip.state_dict().items()},
              os.path.join(root, "text_encoder", "model.safetensors"))
    if tokenizer:
        os.makedirs(os.path.join(root, "tokenizer"))
    return {"vae": os.path.join(root, "vae",
                                "diffusion_pytorch_model.safetensors"),
            "unet": os.path.join(root, "unet", "diffusion_pytorch_model.bin"),
            "clip": os.path.join(root, "text_encoder", "model.safetensors")}


def test_from_pretrained_dir_matches_jax(tmp_path, vae):
    _, _, pvae = vae
    _, _, punet = unet_pair(seed=35)
    _, _, pclip = clip_pair(seed=36)
    files = _diffusers_dir(str(tmp_path), pvae, punet, pclip, tokenizer=True)
    pipe = SDPipeline.from_pretrained_dir(
        str(tmp_path), device="cpu", vae_cfg=VAEConfig(**TINY_VAE),
        unet_cfg=UNetConfig(**TINY_UNET), clip_cfg=CLIPTextConfig(**TINY_CLIP))
    assert pipe.tokenizer_dir == os.path.join(str(tmp_path), "tokenizer")
    for mine, src in ((pipe.vae, pvae), (pipe.unet, punet),
                      (pipe.clip, pclip)):
        theirs = src.state_dict()
        assert all(torch.equal(v, theirs[k])
                   for k, v in mine.state_dict().items())
    jpipe = JSDPipeline(
        frame_size=SIZE,
        vae_params=JW.convert_exhaustive(
            "vae", JW.load_state_dict(files["vae"]), block_out=(8, 16),
            layers_per_block=1),
        unet_params=JW.convert_exhaustive(
            "unet", JW.load_state_dict(files["unet"]), block_out=(8, 16),
            layers_per_block=1),
        clip_params=JW.convert_exhaustive(
            "clip", JW.load_state_dict(files["clip"]), num_layers=1),
        vae_cfg=JVAEConfig(**TINY_VAE), unet_cfg=JUNetConfig(**TINY_UNET),
        clip_cfg=JCLIPConfig(**TINY_CLIP))
    emb = pipe.uncond_embeddings(1)
    jemb = jpipe.uncond_embeddings(1)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), **TOL)
    lat = np.random.default_rng(37).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    with torch.no_grad():
        eps = pipe._unet_eps(nchw(lat), 500.0, emb, 0.0)
    want = jax.jit(lambda p, x, e: jpipe._unet_eps(
        p, x, jnp.float32(500.0), e, 0.0))(jpipe.unet_params,
                                           jnp.asarray(lat), jemb)
    np.testing.assert_allclose(nhwc(eps), np.asarray(want), **TOL)
    img = pipe._decode_pixels(nchw(lat))
    jimg = np.asarray(jpipe._decode_pixels(jnp.asarray(lat)))
    assert img.shape == (1, SIZE, SIZE, 3)
    assert np.abs(img.numpy().astype(int) - jimg.astype(int)).max() <= 1


def test_from_pretrained_dir_keeps_seeded_weights_where_a_file_is_missing(
        tmp_path, vae):
    _, _, pvae = vae
    _, _, punet = unet_pair(seed=38)
    _, _, pclip = clip_pair(seed=39)
    files = _diffusers_dir(str(tmp_path), pvae, punet, pclip)
    os.unlink(files["unet"])
    cfgs = dict(vae_cfg=VAEConfig(**TINY_VAE),
                unet_cfg=UNetConfig(**TINY_UNET),
                clip_cfg=CLIPTextConfig(**TINY_CLIP))
    with pytest.warns(UserWarning, match="no unet weights"):
        pipe = SDPipeline.from_pretrained_dir(str(tmp_path), device="cpu",
                                              **cfgs)
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition
    seeded = build(UNet2DCondition, cfgs["unet_cfg"], "cpu", seed=1)
    assert all(torch.equal(v, seeded.state_dict()[k])
               for k, v in pipe.unet.state_dict().items())
    assert pipe.tokenizer_dir is None
    assert torch.equal(pipe.vae.quant_conv.weight, pvae.quant_conv.weight)
