"""Weight files (``sd_video_gen_tpu_torch/diffusion/weights.py``:
``load_state_dict``, ``convert_exhaustive``, ``load_weights``) against the
JAX package's converters (``sd_video_gen_tpu/diffusion/weights.py``).

The files are in the layouts the published checkpoints use (diffusers VAE of
both vintages, diffusers UNet, transformers CLIP with its ``text_model.``
prefix, the reference's FrameTransformer ``.pt``). At small widths a file is
read by both packages and the forwards compared (f32: rtol 1e-4, atol 1e-5,
summation order only); at full size (``tools/synthetic_checkpoint.py``) the
port's conversion is checked key for key and shape for shape against
modules on the meta device, with no forward.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sd_video_gen_tpu.diffusion import weights as JW
from sd_video_gen_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                               CLIPTextEncoder as JCLIP)
from sd_video_gen_tpu.models.transformer import (
    FrameTransformer as JFT, FrameTransformerConfig as JFTConfig)
from sd_video_gen_tpu.models.unet import (UNet2DCondition as JUNet,
                                          UNetConfig as JUNetConfig)
from sd_video_gen_tpu.models.vae import (AutoencoderKL as JVAE,
                                         VAEConfig as JVAEConfig)
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask

from sd_video_gen_tpu_torch.diffusion import weights as W
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                     CLIPTextEncoder)
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.ops.masks import causal_mask

from torch_port_common import (TINY_CLIP, TINY_FT, TINY_UNET, TINY_VAE,
                               clip_pair, japply, t, unet_pair, vae_pair)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from synthetic_checkpoint import (clip_state_dict, unet_state_dict,  # noqa
                                  vae_state_dict)

TOL = dict(rtol=1e-4, atol=1e-5)
_MODERN = {"query": "to_q", "key": "to_k", "value": "to_v",
           "proj_attn": "to_out.0"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(sd):
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def _vae_file(pm, vintage):
    """The port's tiny VAE as a diffusers file of ``vintage``: '0.2.3'
    (query/key/value/proj_attn), 'modern' (to_q/to_k/to_v/to_out.0) or
    'compvis' (0.2.3 names, the projections as 1x1 convolutions)."""
    out = {}
    for k, v in pm.state_dict().items():
        parts = k.split(".")
        if ".attentions." in k and parts[-2] in _MODERN:
            if vintage == "modern":
                k = ".".join(parts[:-2] + [_MODERN[parts[-2]], parts[-1]])
            elif vintage == "compvis" and parts[-1] == "weight":
                v = v[:, :, None, None]
        out[k] = v.clone()
    return out


@pytest.mark.parametrize("suffix,wrap", [(".pt", False), (".pt", True),
                                         (".bin", False),
                                         (".safetensors", False)])
def test_load_state_dict_round_trips(tmp_path, suffix, wrap):
    sd = {"a.weight": torch.randn(3, 4), "b.bias": torch.randn(5).half(),
          "c": torch.arange(6).reshape(2, 3)}
    path = str(tmp_path / f"w{suffix}")
    if suffix == ".safetensors":
        from safetensors.torch import save_file
        save_file(sd, path)
    else:
        torch.save({"state_dict": sd} if wrap else sd, path)
    back = W.load_state_dict(path)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k])


@pytest.mark.parametrize("vintage", ["0.2.3", "modern", "compvis"])
def test_vae_file_of_each_vintage_matches_jax_convert_vae(tmp_path,
                                                          vintage):
    _, _, src = vae_pair(seed=11)
    sd = _vae_file(src, vintage)
    path = str(tmp_path / "vae.pt")
    torch.save(sd, path)
    pm = W.load_weights(build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu",
                              seed=5), "vae", path)
    jm = JVAE(JVAEConfig(**TINY_VAE))
    params = JW.convert_exhaustive("vae", _np(sd), block_out=(8, 16),
                                   layers_per_block=1)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    jmean, _ = japply(jm, params, jnp.asarray(x), method=JVAE.encode)
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)) \
        .astype(np.float32)
    jdec = japply(jm, params, jnp.asarray(z), method=JVAE.decode)
    with torch.no_grad():
        mean, _ = pm.encode(t(x).permute(0, 3, 1, 2))
        dec = pm.decode(t(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(mean.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jmean), **TOL)
    np.testing.assert_allclose(dec.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdec), **TOL)
    # the weights landed channels-last, where the models run
    assert pm.encoder.conv_in.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_unet_file_matches_jax_convert_unet(tmp_path):
    _, _, src = unet_pair(seed=12)
    path = str(tmp_path / "unet.safetensors")
    from safetensors.torch import save_file
    save_file({k: v.contiguous() for k, v in src.state_dict().items()}, path)
    sd = W.load_state_dict(path)
    pm = W.load_weights(build(UNet2DCondition, UNetConfig(**TINY_UNET),
                              "cpu", seed=5), "unet", sd)
    jm = JUNet(JUNetConfig(**TINY_UNET))
    params = JW.convert_exhaustive("unet", _np(sd), block_out=(8, 16),
                                   layers_per_block=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([981, 1], np.float32)
    ctx = rng.standard_normal((2, 8, 16)).astype(np.float32)
    want = japply(jm, params, jnp.asarray(x), jnp.asarray(ts),
                  jnp.asarray(ctx))
    with torch.no_grad():
        got = pm(t(x).permute(0, 3, 1, 2), t(ts), t(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("prefix", ["text_model.", ""])
def test_clip_file_matches_jax_convert_clip_text(tmp_path, prefix):
    _, _, src = clip_pair(seed=13)
    sd = {prefix + k: v.clone() for k, v in src.state_dict().items()}
    sd[prefix + "embeddings.position_ids"] = torch.arange(8)[None]
    path = str(tmp_path / "clip.pt")
    torch.save(sd, path)
    pm = W.load_weights(build(CLIPTextEncoder, CLIPTextConfig(**TINY_CLIP),
                              "cpu", seed=5), "clip", path)
    jm = JCLIP(JCLIPConfig(**TINY_CLIP))
    params = JW.convert_exhaustive("clip", _np(sd), num_layers=1)
    ids = np.random.default_rng(3).integers(0, 49408, (2, 8))
    want = japply(jm, params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = pm(t(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ref_transformer_file(mode, L=16, seed=14):
    """A reference-layout FrameTransformer ``.pt`` of ``mode`` (the port's
    names are the reference's; the reference also saves its positional
    buffer, and in text mode its frozen sentence encoder)."""
    mc = FrameTransformerConfig(latent_dim=L, mode=mode, frames_to_predict=3,
                                text_embed_dim=8, **TINY_FT)
    src = build(FrameTransformer, mc, "cpu", seed=seed)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator()
                                      .manual_seed(p.numel())))
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    sd["positional_encoder.pos_encoding"] = torch.zeros(64, 1,
                                                        mc.model_width)
    if mode == "text":
        sd["sent_transformer.0.auto_model.embeddings.word_embeddings"
           ".weight"] = torch.zeros(4, 8)
    return mc, sd


@pytest.mark.parametrize("mode", ["ar", "future", "learned_tgt", "text"])
def test_reference_frame_transformer_pt_matches_jax_convert(tmp_path, mode):
    L = 16
    mc, sd = _ref_transformer_file(mode, L)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    pm = W.load_weights(build(FrameTransformer, mc, "cpu", seed=9),
                        "transformer", path)
    jm = JFT(JFTConfig(latent_dim=L, mode=mode, frames_to_predict=3,
                       text_embed_dim=8, dropout_p=0.0, **TINY_FT))
    params = JW.convert_exhaustive("transformer", _np(sd), mode=mode)
    rng = np.random.default_rng(5)
    src = rng.standard_normal((2, 4, L)).astype(np.float32)
    tgt = rng.standard_normal((2, 3, L)).astype(np.float32)
    te = rng.standard_normal((2, 8)).astype(np.float32)
    kw = {"text_embeds": te} if mode == "text" else {}
    causal = mode in ("ar", "text")
    want = japply(jm, params, jnp.asarray(src), jnp.asarray(tgt),
                  tgt_mask=jcausal_mask(3) if causal else None,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = pm(t(src), t(tgt), tgt_mask=causal_mask(3) if causal else None,
                 **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tiny_vae_sd():
    return _vae_file(vae_pair(seed=11)[2], "0.2.3")


@pytest.mark.parametrize("change,match", [
    ("extra", "never consumed"), ("missing", "parameters missing"),
    ("shape", "shape mismatches"), ("twice", "two file keys")])
def test_conversion_is_exhaustive_both_ways(change, match):
    sd = _tiny_vae_sd()
    target = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu")
    if change == "extra":
        sd["encoder.mystery.weight"] = torch.zeros(2)
    elif change == "missing":
        del sd["decoder.conv_in.weight"]
    elif change == "shape":
        sd["quant_conv.bias"] = torch.zeros(16)
    else:   # one attention weight under both vintages' names
        sd["encoder.mid_block.attentions.0.to_q.weight"] = \
            sd["encoder.mid_block.attentions.0.query.weight"]
    before = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        W.load_weights(target, "vae", sd)
    # nothing was loaded
    assert all(torch.equal(before[k], v)
               for k, v in target.state_dict().items())
    with pytest.raises(ValueError, match="unknown model kind"):
        W.convert_exhaustive("i3d", sd, target)


def test_ignored_bookkeeping_keys_are_skipped():
    sd = _tiny_vae_sd()
    sd["encoder.mid_block.num_batches_tracked"] = torch.tensor(3)
    sd["text.position_ids"] = torch.arange(4)
    out = W.convert_exhaustive("vae", sd, build(AutoencoderKL,
                                                VAEConfig(**TINY_VAE), "cpu"))
    assert not any("position_ids" in k or "num_batches" in k for k in out)


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


@pytest.mark.parametrize("kind", ["vae_0.2.3", "vae_modern", "unet", "clip"])
def test_full_size_files_convert_exhaustively(kind):
    """The published SD-v1.4 layouts at full size (no forward): every key
    read, every parameter filled, every shape equal."""
    if kind.startswith("vae"):
        sd, module = vae_state_dict(kind[4:]), _meta(AutoencoderKL,
                                                     VAEConfig())
    elif kind == "unet":
        sd, module = unet_state_dict(), _meta(UNet2DCondition, UNetConfig())
    else:
        sd, module = clip_state_dict(), _meta(CLIPTextEncoder,
                                              CLIPTextConfig())
    out = W.convert_exhaustive(kind.split("_")[0], sd, module)
    want = module.state_dict()
    assert set(out) == set(want)
    assert all(tuple(out[k].shape) == tuple(want[k].shape) for k in want)


def test_build_from_file_fills_a_seeded_module(tmp_path):
    sd = _tiny_vae_sd()
    path = str(tmp_path / "vae.pt")
    torch.save({k: v.half() for k, v in sd.items()}, path)
    m = W.build_from_file(AutoencoderKL, VAEConfig(**TINY_VAE), "vae", path,
                          "cpu", torch.float32, seed=3)
    got = m.state_dict()
    assert all(torch.equal(got[k], sd[k].half().float()) for k in sd)
    assert not m.training and not any(p.requires_grad
                                      for p in m.parameters())
    seeded = W.build_from_file(AutoencoderKL, VAEConfig(**TINY_VAE), "vae",
                               None, "cpu", seed=3)
    assert not torch.equal(seeded.state_dict()["quant_conv.weight"],
                           got["quant_conv.weight"])
