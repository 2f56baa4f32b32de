"""The port's full SDPipeline against the JAX package on the CPU: LMS,
classifier-free guidance, txt2img (LMS and full-range DPM-Solver++), img2img,
the pixel <-> latent helpers and the native-resolution refiner.

Tiny widths (``torch_port_common``), 8x8 latents, 3-4 sampler steps, f32 on
both sides. Tolerances: scheduler constants come from the same numpy / scipy
code: exactly equal. One UNet call: rtol 1e-4 / atol 1e-5. Sampler loops
feed each step's rounding into the next (3-4 UNet calls, guidance 7.5
amplifying the cond - uncond difference): rtol 1e-4 / atol 1e-4 (from pure
noise a random UNet drives latents to ~100, hence the relative part; LMS
starts at sigma ~ 14.6: atol 1e-3 there). uint8 images: at most one level on
at most 1% of pixels.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.diffusion.refine import (make_denoise_refiner as
                                               jmake_refiner)
from sd_video_gen_tpu.diffusion.schedulers import LMSSchedule as JLMS
from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
from sd_video_gen_tpu_torch.diffusion.schedulers import LMSSchedule
from torch_port_common import nchw, nhwc, sd_pair, t

SIZE, H = 16, 8        # 16px frames, 8x8 latents (the tiny VAE halves once)


@pytest.fixture(scope="module")
def pipes():
    return sd_pair(SIZE)


def _embeddings(jpipe, pipe, batch, seed):
    """[uncond; cond] from seeded token ids through both CLIPs (no tokenizer
    files in the repository), cond != uncond."""
    from sd_video_gen_tpu.models.clip_text import empty_prompt_ids
    ids = np.random.default_rng(seed).integers(0, 49406, (batch, 8))
    un = empty_prompt_ids(batch, 8)
    clip = jax.jit(jpipe.clip.apply)
    jemb = jnp.concatenate([clip(jpipe.clip_params, un),
                            clip(jpipe.clip_params,
                                 jnp.asarray(ids, jnp.int32))])
    with torch.no_grad():
        emb = torch.cat([pipe.clip(t(np.asarray(un)).long()),
                         pipe.clip(t(ids).long())])
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-4,
                               atol=1e-5)
    return jemb, emb


def _latents(batch, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((batch, H, H, 4))
            * scale).astype(np.float32)


@pytest.mark.parametrize("steps", [4, 50])
def test_lms_constants_are_the_jax_packages(steps):
    js, ps = JLMS(steps), LMSSchedule(steps)
    np.testing.assert_array_equal(ps.sigmas, np.asarray(js.sigmas))
    np.testing.assert_array_equal(ps.coeffs, np.asarray(js.coeffs))
    np.testing.assert_array_equal(ps.timesteps, js.timesteps)
    assert ps.init_noise_scale() == float(js.init_noise_scale())
    assert ps.sigmas.dtype == ps.coeffs.dtype == np.float32


def test_lms_step_and_scaling_match_jax():
    js, ps = JLMS(6), LMSSchedule(6)
    rng = np.random.default_rng(70)
    x = rng.standard_normal((2, 4, 3, 3)).astype(np.float32) * 10
    jx, jh = jnp.asarray(x), js.init_history(jnp.asarray(x))
    px, ph = t(x), ps.init_history(t(x))
    assert ph.shape == (4, 2, 4, 3, 3)
    for i in range(6):                      # passes the order-4 ramp-up
        eps = rng.standard_normal(x.shape).astype(np.float32)
        np.testing.assert_allclose(ps.scale_input(px, i).numpy(),
                                   np.asarray(js.scale_input(jx, i)),
                                   rtol=1e-6)
        jx, jh = js.step(jnp.asarray(eps), i, jx, jh)
        px, ph = ps.step(t(eps), i, px, ph)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)


def test_cfg_is_one_2b_batch_call_and_static_zero_one_b_batch_call(pipes):
    jpipe, pipe = pipes
    jemb, emb = _embeddings(jpipe, pipe, 2, 71)
    lat = _latents(2, 72)
    batches = []
    hook = pipe.unet.register_forward_pre_hook(
        lambda m, args: batches.append(args[0].shape[0]))
    try:
        with torch.no_grad():
            guided = pipe._unet_eps(nchw(lat), 500.0, emb, 7.5)
            zero = pipe._unet_eps(nchw(lat), 500.0, emb, 0.0)
            traced = pipe._unet_eps(nchw(lat), 500.0, emb, torch.tensor(0.0))
            pair = pipe.unet(torch.cat([nchw(lat)] * 2),
                             torch.full((4,), 500.0), emb)
    finally:
        hook.remove()
    assert batches == [4, 2, 4, 4]
    want = jax.jit(lambda p, x, e: jpipe._unet_eps(
        p, x, jnp.float32(500.0), e, 7.5))(jpipe.unet_params,
                                           jnp.asarray(lat), jemb)
    np.testing.assert_allclose(nhwc(guided), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # guidance 0: the B-batch call is the uncond half of the pair
    torch.testing.assert_close(zero, pair[:2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(traced, pair[:2], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(guided, zero, atol=1e-3)


@pytest.mark.parametrize("sampler,steps,atol", [("lms", 4, 1e-3),
                                                ("dpmpp", 3, 1e-4)])
def test_denoise_img_latents_matches_jax(pipes, sampler, steps, atol):
    jpipe, pipe = pipes
    jemb, emb = _embeddings(jpipe, pipe, 2, 73)
    lat = _latents(2, 74)
    want = jpipe.denoise_img_latents(jemb, SIZE * 4, SIZE * 4, steps, 7.5,
                                     latents=jnp.asarray(lat),
                                     sampler=sampler)
    calls = []
    hook = pipe.unet.register_forward_pre_hook(
        lambda m, args: calls.append(args[0].shape[0]))
    try:
        got = pipe.denoise_img_latents(emb, SIZE * 4, SIZE * 4, steps, 7.5,
                                       latents=nchw(lat), sampler=sampler)
    finally:
        hook.remove()
    assert calls == [4] * steps
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=atol)


def test_denoise_img_latents_draws_its_own_noise_and_checks_the_sampler(pipes):
    _, pipe = pipes
    emb = pipe.uncond_embeddings(1)
    a = pipe.denoise_img_latents(emb, 32, 48, 2, 0.0, sampler="dpmpp")
    b = pipe.denoise_img_latents(emb, 32, 48, 2, 0.0, sampler="dpmpp")
    c = pipe.denoise_img_latents(emb, 32, 48, 2, 0.0, sampler="dpmpp",
                                 generator=torch.Generator().manual_seed(5))
    assert a.shape == (1, 4, 4, 6) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="expected 'lms' or 'dpmpp'"):
        pipe.denoise_img_latents(emb, 32, 32, 2, 0.0, sampler="ddim")


def _jax_i2i_noise(shape):
    """gen_i2i_latents' draw for given latents and the default key."""
    return jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)


@pytest.mark.parametrize("all_latents", [False, True])
def test_gen_i2i_latents_matches_jax(pipes, all_latents):
    jpipe, pipe = pipes
    jemb, emb = _embeddings(jpipe, pipe, 2, 75)
    lat = _latents(2, 76, 0.5)
    want = jpipe.gen_i2i_latents(jemb, num_inference_steps=10,
                                 guidance_scale=7.5, latents=jnp.asarray(lat),
                                 start_step=7, return_all_latents=all_latents)
    got = pipe.gen_i2i_latents(emb, num_inference_steps=10, guidance_scale=7.5,
                               latents=nchw(lat), start_step=7,
                               return_all_latents=all_latents,
                               noise=nchw(_jax_i2i_noise(lat.shape)))
    assert got.shape == ((8 if all_latents else 2), 4, H, H)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_gen_i2i_noise_is_independent_of_drawn_latents(pipes):
    """Latents and noise come from one generator in turn: not the same
    tensor twice (which would give a mixture of std ~1.39)."""
    _, pipe = pipes
    emb = pipe.uncond_embeddings(1)
    g = lambda: torch.Generator().manual_seed(3)
    start = pipe.gen_i2i_latents(emb, 64, 64, 10, 0.0, start_step=9,
                                 generator=g(), return_all_latents=True)[:1]
    lat = torch.randn((1, 4, 8, 8), generator=g())
    from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
    a = float(DDIMSchedule(10).alpha[9])
    noise = (start - a ** 0.5 * lat) / (1 - a) ** 0.5
    corr = torch.corrcoef(torch.stack([noise.flatten(), lat.flatten()]))[0, 1]
    assert abs(corr.item()) < 0.3 and abs(noise.std().item() - 1) < 0.2


def test_img_to_img_and_pixel_helpers_match_jax(pipes):
    jpipe, pipe = pipes
    img = np.random.default_rng(77).integers(0, 256, (2, SIZE, SIZE, 3)
                                             ).astype(np.uint8)
    jlat = jpipe.encode_img(jnp.asarray(img))
    lat = pipe.encode_img(img)
    assert lat.shape == (2, 4, H, H)
    np.testing.assert_allclose(nhwc(lat), np.asarray(jlat), rtol=1e-4,
                               atol=1e-5)
    want = np.asarray(jpipe.img_to_img([""] * 2, jnp.asarray(img), SIZE, SIZE,
                                       10, 7.5, start_step=8))
    got = pipe.img_to_img([""] * 2, img, SIZE, SIZE, 10, 7.5, start_step=8,
                          noise=nchw(_jax_i2i_noise(jlat.shape)))
    assert got.shape == (2, SIZE, SIZE, 3) and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    # any spatial size: 4x6 latents -> 8x12 pixels (the tiny VAE doubles once)
    z = _latents(1, 78)[:, :4, :6]
    wide = pipe._decode_pixels(nchw(z))
    assert wide.shape == (1, 8, 12, 3)
    jwide = np.asarray(jpipe._decode_pixels(jnp.asarray(z)))
    d = np.abs(wide.numpy().astype(int) - jwide.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_prompt_to_img_with_the_empty_prompt_matches_jax(pipes):
    jpipe, pipe = pipes
    lat = _latents(1, 79)
    want = np.asarray(jpipe.prompt_to_img("", SIZE, SIZE, 3, 7.5,
                                          latents=jnp.asarray(lat),
                                          sampler="dpmpp"))
    got = pipe.prompt_to_img("", SIZE, SIZE, 3, 7.5, latents=nchw(lat),
                             sampler="dpmpp")
    assert got.shape == (1, SIZE, SIZE, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_text_entry_points(pipes):
    jpipe, pipe = pipes
    ids = pipe.tokenize(["", ""])
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jpipe.tokenize(["", ""])))
    np.testing.assert_allclose(pipe.encode_text([""]).numpy(),
                               np.asarray(jpipe.encode_text([""])),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pipe.encode_text(["", ""]),
                               pipe.uncond_embeddings(2))
    for p in (pipe, jpipe):
        with pytest.raises(ValueError, match="need a CLIP tokenizer"):
            p.tokenize(["a photo of a cat"])


def test_perturb_latents_matches_jax_and_normalises(pipes):
    jpipe, pipe = pipes
    lat = _latents(2, 80, 3.0) + 1.0
    noise = jax.random.normal(jax.random.PRNGKey(0), lat.shape, jnp.float32)
    want = jpipe.perturb_latents(jnp.asarray(lat), 0.25)
    got = pipe.perturb_latents(t(lat), 0.25, noise=t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    own = pipe.perturb_latents(t(lat), 0.25)
    assert abs(own.mean().item()) < 1e-5
    assert abs(own.std(unbiased=False).item() - 1) < 1e-5   # population std


@pytest.mark.parametrize("sampler,solver_steps", [("ddim", None),
                                                  ("dpmpp", 2)])
def test_native_resolution_refiner_matches_jax(pipes, sampler, solver_steps):
    """hi_res=None: no pixel round trip; the latent grid is the VAE's."""
    jpipe, pipe = pipes
    start, steps = 7, 10
    japply, jparams = jmake_refiner(
        types.SimpleNamespace(frame_size=SIZE), start, pipeline=jpipe,
        num_inference_steps=steps, hi_res=None, sampler=sampler,
        solver_steps=solver_steps)

    def jax_noise(step, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(start), step)
        return t(jax.random.normal(key, shape, jnp.float32))
    refine = make_denoise_refiner(pipe, SIZE, start, steps, hi_res=None,
                                  noise_fn=jax_noise, sampler=sampler,
                                  solver_steps=solver_steps)
    flat = (np.random.default_rng(81).standard_normal((3, 4 * H * H)) * 0.5
            ).astype(np.float32)
    want = jax.jit(japply)(jparams, jnp.asarray(flat), 2)
    with torch.no_grad():
        got = refine(t(flat), 2)
    assert got.shape == (3, 4 * H * H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
