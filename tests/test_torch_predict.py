"""``make_predict_fn`` of the port, branch by branch, against the JAX
package's on the CPU, and the serve loop with labels in the request.

PixelCodec, 16px frames (latent_dim 16), the tiny FrameTransformer of
``torch_port_common``, f32. Tolerance: rtol 1e-4 / atol 1e-5 on context and
predicted latents (other summation orders; int8 branches accumulate in int32
on both sides from exactly equal int8 weights). The native-resolution refiner
branch runs 2 DDIM steps per frame with JAX's noise injected: atol 1e-4.
"""

import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.codecs import PixelCodec as JPixelCodec
from sd_video_gen_tpu.diffusion.refine import (make_denoise_refiner as
                                               jmake_refiner)
from sd_video_gen_tpu.diffusion.vae_codec import VAECodec as JVAECodec
from sd_video_gen_tpu.models.identity import IdentityModel as JIdentity
from sd_video_gen_tpu.models.text_embed import (ClassNameEmbedder as
                                                JClassNameEmbedder)
from sd_video_gen_tpu.ops.cached_rollout import (
    quantize_rollout_params as jquantize_rollout_params)
from sd_video_gen_tpu.ops.quantized import (
    quantize_frame_transformer as jquantize_frame_transformer)
from sd_video_gen_tpu.predict.predict import make_predict_fn as jmake_predict
from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models.identity import IdentityModel
from sd_video_gen_tpu_torch.models.text_embed import ClassNameEmbedder
from sd_video_gen_tpu_torch.predict import serve as S
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn
from torch_port_common import sd_pair, t, transformer_pair

SIZE, L, CONTEXT, PRED = 16, 16, 5, 3
FRAMES = np.random.default_rng(90).integers(
    0, 256, (2, CONTEXT, SIZE, SIZE, 3)).astype(np.uint8)


def _check(jpredict, jparams, predict, *extra, jextra=None, atol=1e-5):
    jctx, jpreds = jpredict(jparams, jnp.asarray(FRAMES),
                            *(jextra if jextra is not None else extra))
    ctx, preds = predict(FRAMES, *extra)
    assert ctx.shape == (2, CONTEXT, L) and ctx.dtype == torch.float32
    assert preds.shape == tuple(jpreds.shape) and preds.dtype == torch.float32
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-4,
                               atol=atol)
    return preds


@pytest.fixture(scope="module")
def ar_pair():
    return transformer_pair(L, seed=91)


@pytest.mark.parametrize("mode,rollout,int8", [
    ("ar", "full", False), ("diff", "full", False), ("ar", "cached", False),
    ("ar", "full", True), ("diff", "full", True), ("ar", "cached", True)])
def test_ar_branches_match_jax(ar_pair, mode, rollout, int8):
    jm, params, pm = ar_pair
    kw = dict(mode=mode, rollout=rollout, int8=int8)
    jparams = params
    if int8:
        jparams = (jquantize_rollout_params if rollout == "cached"
                   else jquantize_frame_transformer)(params)
    jpredict = jmake_predict(jm, JPixelCodec(SIZE), PRED, window=CONTEXT,
                             **kw)
    predict = make_predict_fn(pm, PixelCodec(SIZE, "cpu"), PRED,
                              window=CONTEXT, **kw)
    _check(jpredict, jparams, predict)


def test_diff_adds_the_last_input_latent(ar_pair):
    _, _, pm = ar_pair
    codec = PixelCodec(SIZE, "cpu")
    ctx, ar = make_predict_fn(pm, codec, 1, window=CONTEXT)(FRAMES)
    _, diff = make_predict_fn(pm, codec, 1, window=CONTEXT,
                              mode="diff")(FRAMES)
    torch.testing.assert_close(diff[:, 0], ar[:, 0] + ctx[:, -1])


@pytest.mark.parametrize("mode", ["future", "learned_tgt"])
@pytest.mark.parametrize("pred,horizon", [(3, 3), (2, 3), (3, None)])
def test_single_shot_branches_match_jax(mode, pred, horizon):
    """Fewer frames than the horizon take the first of the span; the refine
    hook runs per frame with its index."""
    jm, params, pm = transformer_pair(L, seed=92, mode=mode,
                                      frames_to_predict=3)
    hook = lambda x, i: x * 0.5 + i
    jpredict = jmake_predict(jm, JPixelCodec(SIZE), pred, window=CONTEXT,
                             mode=mode, future_horizon=horizon,
                             refiner=(lambda rp, x, i: hook(x, i), None))
    predict = make_predict_fn(pm, PixelCodec(SIZE, "cpu"), pred,
                              window=CONTEXT, mode=mode,
                              future_horizon=horizon, refiner=hook)
    jctx, jpreds = jpredict(params, jnp.asarray(FRAMES))
    ctx, preds = predict(FRAMES)
    assert preds.shape == (2, pred, L)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-4,
                               atol=1e-5)


def test_text_branch_matches_jax():
    jm, params, pm = transformer_pair(L, seed=93, mode="text",
                                      text_embed_dim=8)
    labels = [4, 1]
    jemb = JClassNameEmbedder(6, 8)(jnp.asarray(labels, jnp.int32))
    emb = ClassNameEmbedder(6, 8, device="cpu")(labels)
    jpredict = jmake_predict(jm, JPixelCodec(SIZE), PRED, window=CONTEXT,
                             mode="text")
    predict = make_predict_fn(pm, PixelCodec(SIZE, "cpu"), PRED,
                              window=CONTEXT, mode="text")
    _check(jpredict, params, predict, emb, jextra=(jemb,))
    with pytest.raises(ValueError, match="text mode requires text_embeds"):
        predict(FRAMES)


def test_identity_baseline_matches_jax():
    jpredict = jmake_predict(JIdentity(), JPixelCodec(SIZE), PRED,
                             window=CONTEXT)
    predict = make_predict_fn(IdentityModel(), PixelCodec(SIZE, "cpu"), PRED,
                              window=CONTEXT)
    preds = _check(jpredict, {}, predict)
    ctx, _ = predict(FRAMES)
    assert torch.equal(preds, ctx[:, -1:].expand(-1, PRED, -1))


@pytest.mark.parametrize("kw,match", [
    (dict(rollout="cached", mode="diff"), "cached supports --train_mode ar"),
    (dict(mode="future", future_horizon=2), "exceeds the model's trained"),
    (dict(mode="learned_tgt", future_horizon=2), "exceeds the model's"),
    (dict(int8=True, mode="text"), "int8 supports --train_mode ar/diff"),
    (dict(int8=True, mode="future"), "int8 supports --train_mode ar/diff")])
def test_guards_raise_as_the_jax_package_does(ar_pair, kw, match):
    jm, _, pm = ar_pair
    with pytest.raises(ValueError, match=match):
        make_predict_fn(pm, PixelCodec(SIZE, "cpu"), PRED, window=CONTEXT,
                        **kw)
    with pytest.raises(ValueError, match=match):
        jmake_predict(jm, JPixelCodec(SIZE), PRED, window=CONTEXT, **kw)


def test_cached_rollout_with_the_native_refiner_and_the_vae_codec():
    """The evaluation harness's variant: VAE codec, cached rollout, partial
    denoise on the native latent grid (2 DDIM steps per frame)."""
    jpipe, pipe = sd_pair(SIZE)
    start, steps = 8, 10
    jm, params, pm = transformer_pair(4 * 8 * 8, seed=94)
    jrefiner = jmake_refiner(types.SimpleNamespace(frame_size=SIZE), start,
                             pipeline=jpipe, num_inference_steps=steps,
                             hi_res=None)

    def jax_noise(step, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(start), step)
        return t(jax.random.normal(key, shape, jnp.float32))
    refiner = make_denoise_refiner(pipe, SIZE, start, steps, hi_res=None,
                                   noise_fn=jax_noise)
    jcodec = JVAECodec(SIZE, params=jpipe.vae.params, cfg=jpipe.vae.cfg)
    jpredict = jmake_predict(jm, jcodec, 2, window=CONTEXT, refiner=jrefiner,
                             rollout="cached")
    predict = make_predict_fn(pm, VAECodec(SIZE, pipe.vae), 2, window=CONTEXT,
                              refiner=refiner, rollout="cached")
    jctx, jpreds = jpredict(params, jnp.asarray(FRAMES))
    ctx, preds = predict(FRAMES)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-4,
                               atol=1e-4)


def _serve(tmp_path, predict, codec, **kw):
    sock = str(tmp_path / "s.sock")
    th = threading.Thread(target=S.serve,
                          args=(sock, predict, codec.decode_latents),
                          kwargs=dict(frames_per_clip=CONTEXT,
                                      frame_size=SIZE, **kw), daemon=True)
    th.start()
    S.wait_ready(sock, deadline_s=120, poll_s=0.2)
    return sock, th


def test_serve_passes_labels_through_the_embedder(tmp_path):
    """Labels ride in the request header; a ragged request pads frames and
    labels alike; a request without labels is class 0."""
    _, _, pm = transformer_pair(L, seed=93, mode="text", text_embed_dim=8)
    codec = PixelCodec(SIZE, "cpu")
    embedder = ClassNameEmbedder(6, 8, device="cpu")
    predict = make_predict_fn(pm, codec, PRED, window=CONTEXT, mode="text")
    seen = []

    def spy(labels):
        seen.append(list(labels))
        return embedder(labels)
    sock, th = _serve(tmp_path, predict, codec, batch_clips=3, embedder=spy)
    try:
        imgs, is_pred, _ = S.request(sock, FRAMES, labels=[4, 1])
        assert imgs.shape == (2, CONTEXT - 1 + PRED, SIZE, SIZE, 3)
        assert is_pred == [False] * 4 + [True] * PRED
        padded = np.concatenate([FRAMES, FRAMES[-1:]])
        ctx, preds = predict(padded, embedder([4, 1, 1]))
        seq = torch.cat([ctx[:, :-1], preds], dim=1)[:2]
        want = codec.decode_latents(seq.reshape(-1, L)).numpy()
        np.testing.assert_array_equal(imgs, want.reshape(imgs.shape))
        other, _, _ = S.request(sock, FRAMES, labels=[0, 0])
        assert not np.array_equal(other, imgs)
        unlabeled, _, _ = S.request(sock, FRAMES)
        np.testing.assert_array_equal(unlabeled, other)
        with pytest.raises(RuntimeError, match="out of range"):
            S.request(sock, FRAMES, labels=[6, 0])
        # warm-up batch (class 0), then the three served requests
        assert seen == [[0, 0, 0], [4, 1, 1], [0, 0, 0], [0, 0, 0], [6, 0, 0]]
    finally:
        assert S.shutdown(sock)["served"] == 6
        th.join(timeout=30)
    assert not th.is_alive()


def test_serve_without_warmup_opens_the_socket_first(tmp_path, ar_pair):
    _, _, pm = ar_pair
    codec = PixelCodec(SIZE, "cpu")
    calls = []
    inner = make_predict_fn(pm, codec, PRED, window=CONTEXT)

    def predict(frames, text_embeds=None):
        calls.append(len(frames))
        return inner(frames, text_embeds)
    sock, th = _serve(tmp_path, predict, codec, batch_clips=2, warmup=False)
    try:
        assert calls == []
        S.request(sock, FRAMES[:1])
        assert calls == [2]
    finally:
        S.shutdown(sock)
        th.join(timeout=30)
    assert not th.is_alive()


@pytest.mark.parametrize("labels", [None, [3, 0]])
def test_request_header_is_the_jax_packages(tmp_path, labels):
    """Both clients send one listener the same predict request, with and
    without labels."""
    import socket
    from sd_video_gen_tpu.predict import serve as JS
    sock = str(tmp_path / "l.sock")
    got = []

    def listener():
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as srv:
            srv.bind(sock)
            srv.listen(2)
            ready.set()
            for _ in range(2):
                conn, _ = srv.accept()
                with conn:
                    got.append(S._recv_msg(conn))
                    S._send_msg(conn, {"shape": [1, 1, 1, 1, 3],
                                       "is_pred": [True]}, b"abc")
    ready = threading.Event()
    th = threading.Thread(target=listener, daemon=True)
    th.start()
    assert ready.wait(timeout=10)
    for mod in (S, JS):
        imgs, flags, _ = mod.request(sock, FRAMES[:1, :1], labels=labels)
        assert imgs.shape == (1, 1, 1, 1, 3) and flags == [True]
    th.join(timeout=10)
    assert not th.is_alive() and len(got) == 2 and got[0] == got[1]
    assert got[0][0].get("labels") == labels
