"""The port's PixelCodec and codec factory against the JAX package on the CPU.

Tolerance: the encode is an antialiased bilinear resize in f32 on both sides
(a normalised triangle filter as wide as the scale), summed in another
order: latents agree to atol 1e-6. The decode rounds to uint8, so a value on
a rounding boundary may flip one level: images differ by at most one level
on at most 0.1% of pixels.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.codecs import PixelCodec as JPixelCodec
from sd_video_gen_tpu_torch.codecs import PixelCodec, make_codec
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from torch_port_common import t, vae_pair


def _frames(size, seed=0, shape=(2, 3)):
    return np.random.default_rng(seed).integers(
        0, 256, shape + (size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("size", [16, 32, 64])
def test_pixel_encode_matches_jax(size):
    frames = _frames(size)
    want = np.asarray(JPixelCodec(size).encode_frames(jnp.asarray(frames)))
    codec = PixelCodec(size, "cpu")
    got = codec.encode_frames(t(frames))
    assert got.shape == (2, 3, codec.latent_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [16, 32, 64])
def test_pixel_decode_matches_jax(size):
    jc = JPixelCodec(size)
    lat = (np.random.default_rng(1).standard_normal((5, jc.latent_dim))
           * 0.7).astype(np.float32)       # some values clip at both ends
    want = np.asarray(jc.decode_latents(jnp.asarray(lat)))
    got = PixelCodec(size, "cpu").decode_latents(t(lat))
    assert got.shape == (5, size, size, 3) and got.dtype == torch.uint8
    assert got.is_contiguous()
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_pixel_layout_is_channel_major_bgr_luma():
    """A frame of one colour encodes to constant planes [B, G, R, luma]."""
    frame = np.zeros((1, 1, 16, 16, 3), np.uint8)
    frame[..., 0], frame[..., 1], frame[..., 2] = 255, 0, 51
    lat = PixelCodec(16, "cpu").encode_frames(t(frame)).reshape(4, 2, 2)
    want = torch.tensor([1.0, -1.0, -0.6, -0.2])
    torch.testing.assert_close(lat, want[:, None, None].expand(4, 2, 2),
                               rtol=0, atol=1e-6)


def test_pixel_encode_batch_prepends_sos_unless_told_not_to():
    frames = _frames(16)
    codec = PixelCodec(16, "cpu")
    jc = JPixelCodec(16)
    with_sos = codec.encode_batch(t(frames))
    assert with_sos.shape == (2, 4, codec.latent_dim)
    assert torch.all(with_sos[:, 0] == 2.0)
    np.testing.assert_allclose(
        with_sos.numpy(), np.asarray(jc.encode_batch(jnp.asarray(frames))),
        rtol=0, atol=1e-6)
    torch.testing.assert_close(codec.encode_batch(t(frames), use_sos=False),
                               with_sos[:, 1:])


def test_vae_codec_encode_batch_takes_use_sos():
    _, _, pvae = vae_pair(seed=3)
    codec = VAECodec(8, pvae)
    frames = t(_frames(8))
    with torch.no_grad():
        assert codec.encode_batch(frames).shape == (2, 4, codec.latent_dim)
        assert codec.encode_batch(frames, use_sos=False).shape == (
            2, 3, codec.latent_dim)


def test_pixel_codec_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert PixelCodec(16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PixelCodec(16)
    assert PixelCodec(16, "cpu").device.type == "cpu"


def test_make_codec_kinds():
    cfg = types.SimpleNamespace(frame_size=16)
    pix = make_codec(cfg, "pixel", device="cpu")
    assert isinstance(pix, PixelCodec) and pix.latent_dim == 16
    _, _, pvae = vae_pair(seed=3)
    vae = make_codec(cfg, "vae", vae=pvae)
    assert isinstance(vae, VAECodec) and vae.model is pvae
    with pytest.raises(ValueError, match="unknown codec kind"):
        make_codec(cfg, "wavelet")
