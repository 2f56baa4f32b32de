"""The port's denoised AR serving slice against the JAX package on the CPU:
ar_rollout (full and short context), make_predict_fn with the partial-denoise
refiner (JAX's fold-in noise injected), the serve loop over a socket, and
import hygiene (no jax / flax / optax / yaml / cv2 anywhere in the port or in
chip_smoke.py's imports).

Tolerance: f32 on both sides. The rollout without refinement agrees to
rtol 1e-4 / atol 1e-5. With refinement every frame passes through uint8
twice (decode -> resize -> encode), so a value on a rounding boundary may
flip one level and move the re-encoded latent: predicted latents agree to
atol 1e-3, decoded frames differ by at most one level on at most 1% of
pixels.
"""

import os
import subprocess
import sys
import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.diffusion.refine import (make_denoise_refiner as
                                               jmake_refiner)
from sd_video_gen_tpu.diffusion.sd import SDPipeline as JSDPipeline
from sd_video_gen_tpu.diffusion.vae_codec import VAECodec as JVAECodec
from sd_video_gen_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from sd_video_gen_tpu.models.unet import UNetConfig as JUNetConfig
from sd_video_gen_tpu.models.vae import VAEConfig as JVAEConfig
from sd_video_gen_tpu.ops.rollout import ar_rollout as jar_rollout
from sd_video_gen_tpu.predict.predict import make_predict_fn as jmake_predict
from sd_video_gen_tpu_torch.diffusion.refine import (default_noise,
                                                     make_denoise_refiner,
                                                     resize_nearest)
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.ops.rollout import ar_rollout
from sd_video_gen_tpu_torch.predict import serve as S
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn
from torch_port_common import (TINY_CLIP, TINY_UNET, TINY_VAE, clip_pair, t,
                               transformer_pair, unet_pair, vae_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LO, HI, START, STEPS, PRED = 8, 16, 8, 10, 3   # 2 DDIM steps per frame


@pytest.mark.parametrize("context_frames", [5, 2])
def test_ar_rollout_matches_jax(context_frames):
    """5 context frames fill the window; 2 need the left pad."""
    L = 16
    jm, params, pm = transformer_pair(L, seed=12)
    ctx = np.random.default_rng(13).standard_normal(
        (2, context_frames + 1, L)).astype(np.float32)
    hook = lambda x, step: x * 0.5 + step       # step index reaches the hook
    want = jax.jit(lambda p, c: jar_rollout(
        jm.apply, p, c, pred_frames=4, window=5,
        refine_fn=lambda x, i: hook(x, i)))(params, jnp.asarray(ctx))
    steps = []

    def rec(x, step):
        steps.append(step)
        return hook(x, step)
    with torch.no_grad():
        got = ar_rollout(pm, t(ctx), pred_frames=4, window=5, refine_fn=rec)
    assert steps == [0, 1, 2, 3]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_resize_nearest_matches_jax_half_pixel_centres():
    x = np.arange(16 * 16 * 3, dtype=np.int64).reshape(1, 16, 16, 3) % 256
    x = x.astype(np.uint8)
    for size in (2, 4, 32):
        want = jax.image.resize(jnp.asarray(x), (1, size, size, 3), "nearest")
        np.testing.assert_array_equal(resize_nearest(t(x), size).numpy(),
                                      np.asarray(want))


def test_default_noise_is_fresh_per_step_and_reproducible():
    draw = default_noise(40, torch.device("cpu"))
    a, b = draw(1, (2, 8, 8, 4)), draw(2, (2, 8, 8, 4))
    assert a.shape == (2, 8, 8, 4)
    torch.testing.assert_close(a, draw(1, (2, 8, 8, 4)), rtol=0, atol=0)
    assert not torch.equal(a, b)
    assert not torch.equal(a, default_noise(41, "cpu")(1, (2, 8, 8, 4)))


@pytest.fixture(scope="module")
def slice_pair():
    jvae, vparams, pvae = vae_pair(seed=20)
    _, uparams, punet = unet_pair(seed=21)
    _, cparams, pclip = clip_pair(seed=22)
    jm, tparams, pm = transformer_pair(4 * (LO // 2) ** 2, seed=23)
    vcfg = JVAEConfig(**TINY_VAE)
    jpipe = JSDPipeline(frame_size=HI, vae_params=vparams,
                        unet_params=uparams, clip_params=cparams,
                        vae_cfg=vcfg, unet_cfg=JUNetConfig(**TINY_UNET),
                        clip_cfg=JCLIPConfig(**TINY_CLIP))
    jrefiner = jmake_refiner(types.SimpleNamespace(frame_size=LO), START,
                             pipeline=jpipe, num_inference_steps=STEPS,
                             hi_res=HI)
    jpredict = jmake_predict(jm, JVAECodec(LO, params=vparams, cfg=vcfg),
                             PRED, window=5, refiner=jrefiner)

    def jax_noise(step, shape):  # the draw inside the JAX refiner
        key = jax.random.fold_in(jax.random.PRNGKey(START), step)
        return t(jax.random.normal(key, shape, jnp.float32))

    pipe = SDPipeline(pvae, punet, pclip)
    refiner = make_denoise_refiner(pipe, LO, START, STEPS, hi_res=HI,
                                   noise_fn=jax_noise)
    codec = VAECodec(LO, pvae)
    predict = make_predict_fn(pm, codec, PRED, window=5, refiner=refiner)
    frames = np.random.default_rng(24).integers(
        0, 256, (2, 5, LO, LO, 3)).astype(np.uint8)
    return dict(jax=(jpredict, tparams, jpipe), port=(predict, codec),
                frames=frames)


def test_predict_with_refiner_matches_jax(slice_pair):
    jpredict, tparams, jpipe = slice_pair["jax"]
    predict, codec = slice_pair["port"]
    frames = slice_pair["frames"]
    jctx, jpreds = jpredict(tparams, jnp.asarray(frames))
    ctx, preds = predict(frames)
    assert preds.shape == jpreds.shape == (2, PRED, codec.latent_dim)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), atol=1e-3)
    jcodec = JVAECodec(LO, params=jpipe.vae.params, cfg=jpipe.vae.cfg)
    jimg = np.asarray(jax.jit(jcodec.decode_latents)(
        jpreds.reshape(-1, codec.latent_dim)))
    with torch.no_grad():
        img = codec.decode_latents(preds.reshape(-1, codec.latent_dim))
    diff = np.abs(img.numpy().astype(int) - jimg.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_serve_answers_a_request_over_a_socket(slice_pair, tmp_path):
    predict, codec = slice_pair["port"]
    frames = slice_pair["frames"]
    sock = str(tmp_path / "s.sock")
    th = threading.Thread(target=S.serve, args=(sock, predict,
                                                codec.decode_latents),
                          kwargs=dict(batch_clips=2, frames_per_clip=5,
                                      frame_size=LO), daemon=True)
    th.start()
    S.wait_ready(sock, deadline_s=120, poll_s=0.2)
    imgs, is_pred, hdr = S.request(sock, frames[:1])   # ragged: padded to 2
    assert imgs.shape == (1, 4 + PRED, LO, LO, 3) and imgs.dtype == np.uint8
    assert is_pred == [False] * 4 + [True] * PRED
    ctx, preds = predict(frames[:1].repeat(2, axis=0))
    seq = torch.cat([ctx[:, :-1], preds], dim=1)[:1]
    want = codec.decode_latents(seq.reshape(-1, codec.latent_dim)).numpy()
    np.testing.assert_array_equal(imgs[0], want)
    assert S.shutdown(sock)["served"] == 1
    th.join(timeout=30)
    assert not th.is_alive()


def test_port_imports_no_jax_flax_optax_yaml_cv2():
    pkg = os.path.join(REPO, "sd_video_gen_tpu_torch")
    mods = sorted(
        ("sd_video_gen_tpu_torch." + os.path.relpath(os.path.join(d, f), pkg)
         [:-3].replace(os.sep, ".")).removesuffix(".__init__")
        for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py"))
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'yaml', 'cv2', 'jaxlib')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    assert "sd_video_gen_tpu_torch.ops.attention" in mods
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
