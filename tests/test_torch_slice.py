"""The port's denoised AR serving slice against the JAX package on the CPU:
ar_rollout (full and short context), make_predict_fn with the partial-denoise
refiner (JAX's fold-in noise injected) with DDIM at B=2 and DPM-Solver++ at
B=3, the serve loop over a socket (ragged requests padded), its wire framing
against the JAX package's, and import hygiene (no jax / flax / optax / yaml
/ cv2 / transformers, and nothing of the JAX package, anywhere in the port or in
chip_smoke.py's imports).

Tolerance: f32 on both sides. The rollout without refinement agrees to
rtol 1e-4 / atol 1e-5. With refinement every frame passes through uint8
twice (decode -> resize -> encode), so a value on a rounding boundary may
flip one level and move the re-encoded latent: predicted latents agree to
atol 1e-3, decoded frames differ by at most one level on at most 1% of
pixels.
"""

import os
import re
import socket
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
from sd_video_gen_tpu.predict import serve as JS
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
SOLVER_STEPS = 3                                # DPM-Solver++ over the same


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


def test_resize_nearest_keeps_the_frames_memory_and_copies_nothing_back():
    """The (N, 3, H, W) view of NHWC frames is channels-last and stays so
    through the resize, so the permute back is already contiguous."""
    import torch.nn.functional as F
    x = t(np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3))
          .astype(np.uint8))
    view = x.permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=torch.channels_last)
    up = F.interpolate(view.float(), size=(16, 16), mode="nearest-exact")
    assert up.is_contiguous(memory_format=torch.channels_last)
    assert up.permute(0, 2, 3, 1).is_contiguous()
    out = resize_nearest(x, 16)
    assert out.is_contiguous() and out.shape == (2, 16, 16, 3)


def test_latents_flatten_channel_major_byte_for_byte():
    """The model runs channels-last, the latents keep the JAX package's
    channel-major flatten: ``encode_frames`` returns exactly the bytes of the
    contiguous (N, 4, h, w) latents, ``decode_latents`` reads them back in
    that order and returns contiguous NHWC uint8 frames."""
    from sd_video_gen_tpu_torch.diffusion.vae_codec import SD_LATENT_SCALE
    _, _, pvae = vae_pair(seed=20)
    codec = VAECodec(LO, pvae)
    frames = t(np.random.default_rng(3).integers(
        0, 256, (2, 3, LO, LO, 3)).astype(np.uint8))
    with torch.no_grad():
        lat = codec.encode_frames(frames)
        x = (frames.float() / 255.0 * 2.0 - 1.0).reshape(6, LO, LO, 3)
        mean, _ = pvae.encode(x.permute(0, 3, 1, 2).contiguous())
        want = (mean.float() * SD_LATENT_SCALE).contiguous()   # NCHW bytes
        assert want.is_contiguous() and want.shape == (6, 4, LO // 2, LO // 2)
        assert lat.is_contiguous() and lat.shape == (2, 3, codec.latent_dim)
        assert lat.numpy().tobytes() == want.numpy().tobytes()
        img = codec.decode_latents(lat.reshape(6, -1))
        direct = pvae.decode(want / SD_LATENT_SCALE)
    assert img.is_contiguous() and img.shape == (6, LO, LO, 3)
    direct = torch.round(torch.clamp(direct / 2 + 0.5, 0, 1) * 255)
    assert torch.equal(img, direct.to(torch.uint8).permute(0, 2, 3, 1))


def test_default_noise_is_fresh_per_step_and_reproducible():
    draw = default_noise(40, torch.device("cpu"))
    a, b = draw(1, (2, 8, 8, 4)), draw(2, (2, 8, 8, 4))
    assert a.shape == (2, 8, 8, 4)
    torch.testing.assert_close(a, draw(1, (2, 8, 8, 4)), rtol=0, atol=0)
    assert not torch.equal(a, b)
    assert not torch.equal(a, default_noise(41, "cpu")(1, (2, 8, 8, 4)))


def _slice(sampler="ddim", solver_steps=None, batch=2):
    """The JAX and the port's predict over the same tiny models, with the
    refiner's sampler, and ``batch`` clips of frames."""
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
                             hi_res=HI, sampler=sampler,
                             solver_steps=solver_steps)
    jpredict = jmake_predict(jm, JVAECodec(LO, params=vparams, cfg=vcfg),
                             PRED, window=5, refiner=jrefiner)

    def jax_noise(step, shape):  # the draw inside the JAX refiner
        key = jax.random.fold_in(jax.random.PRNGKey(START), step)
        return t(jax.random.normal(key, shape, jnp.float32))

    pipe = SDPipeline(pvae, punet, pclip)
    refiner = make_denoise_refiner(pipe, LO, START, STEPS, hi_res=HI,
                                   noise_fn=jax_noise, sampler=sampler,
                                   solver_steps=solver_steps)
    codec = VAECodec(LO, pvae)
    predict = make_predict_fn(pm, codec, PRED, window=5, refiner=refiner)
    frames = np.random.default_rng(24).integers(
        0, 256, (batch, 5, LO, LO, 3)).astype(np.uint8)
    return dict(jax=(jpredict, tparams, jpipe), port=(predict, codec),
                frames=frames)


@pytest.fixture(scope="module")
def slice_pair():
    return _slice()


@pytest.fixture(scope="module")
def dpmpp_pair():
    return _slice("dpmpp", SOLVER_STEPS, batch=3)


def _check_predict_matches_jax(pair):
    jpredict, tparams, jpipe = pair["jax"]
    predict, codec = pair["port"]
    frames = pair["frames"]
    jctx, jpreds = jpredict(tparams, jnp.asarray(frames))
    ctx, preds = predict(frames)
    assert preds.shape == jpreds.shape == (len(frames), PRED,
                                           codec.latent_dim)
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


def test_predict_with_refiner_matches_jax(slice_pair):
    _check_predict_matches_jax(slice_pair)


def test_predict_with_dpmpp_refiner_at_b3_matches_jax(dpmpp_pair):
    _check_predict_matches_jax(dpmpp_pair)


def _check_serve_pads_a_ragged_request(pair, tmp_path, batch_clips):
    predict, codec = pair["port"]
    sent = pair["frames"][:batch_clips - 1]   # ragged: padded to batch_clips
    sock = str(tmp_path / "s.sock")
    th = threading.Thread(target=S.serve, args=(sock, predict,
                                                codec.decode_latents),
                          kwargs=dict(batch_clips=batch_clips,
                                      frames_per_clip=5, frame_size=LO),
                          daemon=True)
    th.start()
    S.wait_ready(sock, deadline_s=120, poll_s=0.2)
    n = len(sent)
    imgs, is_pred, hdr = S.request(sock, sent)
    assert imgs.shape == (n, 4 + PRED, LO, LO, 3) and imgs.dtype == np.uint8
    assert is_pred == [False] * 4 + [True] * PRED
    padded = np.concatenate([sent, sent[-1:].repeat(batch_clips - n, 0)])
    ctx, preds = predict(padded)
    seq = torch.cat([ctx[:, :-1], preds], dim=1)[:n]
    want = codec.decode_latents(seq.reshape(-1, codec.latent_dim)).numpy()
    np.testing.assert_array_equal(imgs, want.reshape(imgs.shape))
    assert S.shutdown(sock)["served"] == n
    th.join(timeout=30)
    assert not th.is_alive()


def test_serve_answers_a_request_over_a_socket(slice_pair, tmp_path):
    _check_serve_pads_a_ragged_request(slice_pair, tmp_path, batch_clips=2)


def test_serve_at_batch_clips_3_pads_a_2_clip_request(dpmpp_pair, tmp_path):
    _check_serve_pads_a_ragged_request(dpmpp_pair, tmp_path, batch_clips=3)


@pytest.mark.parametrize("header,payload", [
    ({"op": "ping"}, b""),
    ({"op": "predict", "shape": [1, 2, 2, 2, 3]}, bytes(range(24)))])
def test_wire_framing_is_the_jax_packages_byte_for_byte(header, payload):
    """The port's server and client speak the JAX package's protocol."""
    def sent_by(send):
        a, b = socket.socketpair()
        with a, b:
            send(a, header, payload)
            a.shutdown(socket.SHUT_WR)
            return b"".join(iter(lambda: b.recv(1 << 16), b""))
    raw = sent_by(S._send_msg)
    assert raw == sent_by(JS._send_msg)
    for send, recv in [(S._send_msg, JS._recv_msg), (JS._send_msg,
                                                     S._recv_msg)]:
        a, b = socket.socketpair()
        with a, b:
            send(a, header, payload)
            assert recv(b) == (header, payload)


def test_port_imports_no_jax_flax_optax_yaml_cv2():
    """Importing every module of the port (and ``chip_smoke``) with jax,
    flax, optax, orbax, yaml, cv2, transformers, the JAX package, the JAX
    bench (``bench.py``) and the repository's ``tools/`` blocked: none may
    be imported at import time
    (yaml and cv2 only inside the functions that need them). Neither may
    the port's source nor ``chip_smoke.py`` reach ``tools/`` another way
    (a ``sys.path`` entry, or an import inside a ``-c`` string), since a
    subprocess's imports are not seen here."""
    pkg = os.path.join(REPO, "sd_video_gen_tpu_torch")
    mods = sorted(
        ("sd_video_gen_tpu_torch." + os.path.relpath(os.path.join(d, f), pkg)
         [:-3].replace(os.sep, ".")).removesuffix(".__init__")
        for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py"))
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith((".py", ".sh"))]
    for path in sources + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            src = f.read()
        assert not re.search(r"sys\.path\.(insert|append)\([^)]*tools", src), \
            path
        assert not re.search(r"^\s*(from|import)\s+(tools|synthetic_checkpoint"
                             r"|bench)\b", src, re.M), path
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'yaml', 'cv2',\n"
        "          'transformers', 'wandb', 'sd_video_gen_tpu', 'tools',\n"
        "          'bench'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'yaml', 'cv2', 'jaxlib',\n"
        "        'transformers', 'wandb', 'sd_video_gen_tpu', 'tools',\n"
        "        'bench')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    assert {"sd_video_gen_tpu_torch.ops.attention",
            "sd_video_gen_tpu_torch.ops.groupnorm",
            "sd_video_gen_tpu_torch.ops.quantized",
            "sd_video_gen_tpu_torch.ops.cached_rollout",
            "sd_video_gen_tpu_torch.models.identity",
            "sd_video_gen_tpu_torch.models.text_embed",
            "sd_video_gen_tpu_torch.config",
            "sd_video_gen_tpu_torch.ops.losses",
            "sd_video_gen_tpu_torch.train.optim",
            "sd_video_gen_tpu_torch.train.trainer",
            "sd_video_gen_tpu_torch.train.checkpoint",
            "sd_video_gen_tpu_torch.train.metrics",
            "sd_video_gen_tpu_torch.data",
            "sd_video_gen_tpu_torch.data.synthetic",
            "sd_video_gen_tpu_torch.data.frame_datasets",
            "sd_video_gen_tpu_torch.data.pipeline",
            "sd_video_gen_tpu_torch.data.latent_cache",
            "sd_video_gen_tpu_torch.utils.profiling",
            "sd_video_gen_tpu_torch.utils.preprocess",
            "sd_video_gen_tpu_torch.utils.video",
            "sd_video_gen_tpu_torch.utils.format_data",
            "sd_video_gen_tpu_torch.data.ucf101",
            "sd_video_gen_tpu_torch.data.native_loader",
            "sd_video_gen_tpu_torch.parallel",
            "sd_video_gen_tpu_torch.parallel.mesh",
            "sd_video_gen_tpu_torch.parallel.multihost",
            "sd_video_gen_tpu_torch.tools.quality_modes",
            "sd_video_gen_tpu_torch.tools.dpmpp_quality_gate",
            "sd_video_gen_tpu_torch.tools.synthetic_checkpoint",
            "sd_video_gen_tpu_torch.tools.bench_harness",
            "sd_video_gen_tpu_torch.bench",
            "sd_video_gen_tpu_torch.tools.bench_knee",
            "sd_video_gen_tpu_torch.tools.bench_attention",
            "sd_video_gen_tpu_torch.tools.bench_cli_serving",
            "sd_video_gen_tpu_torch.tools.bench_cli_train",
            "sd_video_gen_tpu_torch.tools.bench_ucf_loader",
            "sd_video_gen_tpu_torch.tools.counted",
            "sd_video_gen_tpu_torch.examples.ball_demo",
            "sd_video_gen_tpu_torch.examples.serving_demo"} <= set(mods)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
