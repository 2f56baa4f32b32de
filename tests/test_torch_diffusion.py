"""Port of diffusion/{schedulers,sd,weights}: DDIM constants and steps, the
guidance-0 partial denoise, the empty-prompt embedding, and the bridge's
exhaustiveness in both directions.

Tolerance: f32 on both sides. DDIM constants are equal; a DDIM step agrees
to f32 rounding (rtol 1e-6); a partial denoise through the tiny UNet to
rtol 1e-4 / atol 1e-5 (convolution summation order).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.diffusion.schedulers import DDIMSchedule as JDDIM
from sd_video_gen_tpu.diffusion.sd import SDPipeline as JSDPipeline
from sd_video_gen_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from sd_video_gen_tpu.models.unet import UNetConfig as JUNetConfig
from sd_video_gen_tpu.models.vae import VAEConfig as JVAEConfig
from sd_video_gen_tpu_torch.diffusion import weights as W
from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from torch_port_common import (TINY_CLIP, TINY_UNET, TINY_VAE, clip_pair,
                               np_tree, t, transformer_pair, unet_pair,
                               vae_pair)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("steps", [7, 10, 50])
def test_ddim_constants_match_jax_and_fixture(steps):
    ours, ref = DDIMSchedule(steps), JDDIM(steps)
    np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
    assert ours.n_steps == ref.n_steps
    np.testing.assert_array_equal(ours.alpha, np.asarray(ref.alpha))
    np.testing.assert_array_equal(ours.alpha_prev, np.asarray(ref.alpha_prev))
    if steps in (10, 50):
        fx = np.load(os.path.join(FIXDIR, "scheduler_constants.npz"))
        np.testing.assert_array_equal(ours.timesteps,
                                      fx[f"ddim{steps}/timesteps"])


@pytest.mark.parametrize("i", [0, 4, 9])
def test_ddim_step_and_add_noise_match_jax(i):
    rng = np.random.default_rng(i)
    x, eps, noise = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32) * 2
                     for _ in range(3))
    ours, ref = DDIMSchedule(10), JDDIM(10)
    np.testing.assert_allclose(
        ours.step(t(eps), i, t(x)).numpy(),
        np.asarray(ref.step(jnp.asarray(eps), i, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ours.add_noise_at(t(x), t(noise), i).numpy(),
        np.asarray(ref.add_noise_at(jnp.asarray(x), jnp.asarray(noise), i)),
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pipes():
    jvae, vparams, pvae = vae_pair(seed=5)
    junet, uparams, punet = unet_pair(seed=6)
    jclip, cparams, pclip = clip_pair(seed=7)
    jpipe = JSDPipeline(frame_size=16, vae_params=vparams,
                        unet_params=uparams, clip_params=cparams,
                        vae_cfg=JVAEConfig(**TINY_VAE),
                        unet_cfg=JUNetConfig(**TINY_UNET),
                        clip_cfg=JCLIPConfig(**TINY_CLIP))
    return jpipe, SDPipeline(pvae, punet, pclip)


def test_uncond_embeddings_match_jax(pipes):
    jpipe, pipe = pipes
    want = np.asarray(jpipe.uncond_embeddings(2))
    got = pipe.uncond_embeddings(2)
    assert got.shape == want.shape == (4, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_i2i_scan_with_injected_noise_matches_jax(pipes):
    jpipe, pipe = pipes
    emb = jpipe.uncond_embeddings(2)
    lat = np.random.default_rng(8).standard_normal(
        (2, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    run = jax.jit(lambda p, x, e: jpipe.i2i_scan(
        p, x, e, guidance_scale=0.0, start_step=7, num_inference_steps=10,
        noise_rng=key))
    want = np.asarray(run(jpipe.unet_params, jnp.asarray(lat), emb))
    noise = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    with torch.no_grad():
        got = pipe.i2i_scan(t(lat).permute(0, 3, 1, 2), t(emb), 7, 10,
                            noise=t(noise).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="needs noise"):
        pipe.i2i_scan(t(lat).permute(0, 3, 1, 2), t(emb), 7, 10)


@pytest.mark.parametrize("kind,pair", [("vae", vae_pair), ("unet", unet_pair),
                                       ("clip", clip_pair),
                                       ("transformer", None)])
def test_bridge_assigns_every_param_and_uses_every_leaf(kind, pair):
    _, params, module = (pair(seed=9) if pair else
                         transformer_pair(16, seed=9))
    tree = np_tree(params)["params"]
    n_leaves = len(jax.tree.leaves(tree))
    sd = {"vae": W.vae_state_dict, "unet": W.unet_state_dict,
          "clip": W.clip_text_state_dict,
          "transformer": W.frame_transformer_state_dict}[kind](tree)
    fused = {"unet": 2, "transformer": 3}.get(kind)
    # every leaf lands once: fused keys absorb 2 (GEGLU) or 3 (q, k, v) leaves
    n_fused = sum(1 for k in sd if k.endswith((".ff.net.0.proj.weight",
                                               ".ff.net.0.proj.bias",
                                               "multihead_attn.in_proj_weight",
                                               "multihead_attn.in_proj_bias")))
    assert len(sd) + n_fused * ((fused or 1) - 1) == n_leaves
    assert set(sd) == set(module.state_dict())
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_bridge_refuses_missing_extra_and_misshaped():
    _, params, _ = unet_pair(seed=10)
    tree = np_tree(params)["params"]
    fresh = lambda: build(UNet2DCondition, UNetConfig(**TINY_UNET))
    dropped = {k: v for k, v in tree.items() if k != "conv_out"}
    with pytest.raises(ValueError, match="unassigned.*conv_out"):
        W.load_jax_params(fresh(), "unet", dropped)
    extra = dict(tree, stray={"kernel": np.zeros((3, 3))})
    with pytest.raises(ValueError, match="unused.*stray"):
        W.load_jax_params(fresh(), "unet", extra)
    bad = dict(tree, conv_in={"kernel": np.zeros((3, 3, 4, 9), np.float32),
                              "bias": np.zeros(9, np.float32)})
    with pytest.raises(ValueError, match="shape mismatches conv_in"):
        W.load_jax_params(fresh(), "unet", bad)
    half = {**tree}
    blk = dict(half["down_0_attn_0"]["block_0"])
    blk["ff"] = {k: v for k, v in blk["ff"].items() if k != "geglu_proj_h"}
    half["down_0_attn_0"] = dict(half["down_0_attn_0"], block_0=blk)
    with pytest.raises(ValueError, match="missing fused parts"):
        W.load_jax_params(fresh(), "unet", half)
