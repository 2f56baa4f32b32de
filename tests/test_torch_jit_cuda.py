"""The port's compiled programs (``utils/jit.py``) on the card.

Every test here carries the ``cuda`` marker and skips without a GPU: a CUDA
graph is captured on the card only. Torch only, so it runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jit_cuda.py -m cuda

A compiled request runs the same kernels on the same inputs as the eager
one: equal bit for bit, with the same launches by body. So does a compiled
training step (its state updated in place inside the graph, its dropout
drawn from a generator registered with the capture).
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                     CLIPTextEncoder)
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.ops.losses import LossWeights
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn
from sd_video_gen_tpu_torch.tools.bench_harness import launch_window
from sd_video_gen_tpu_torch.train.trainer import make_train_step
from sd_video_gen_tpu_torch.utils import jit as J


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the compiled path captures CUDA "
                    "graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_capturing_a_host_sync_raises_naming_the_op(cuda):
    f = J.jit(lambda x: x * x.sum().item(), name="item")
    with pytest.raises(RuntimeError, match=r"jit\(item\).*after TensorBase\.item"):
        f(torch.ones(4, device=cuda))
    assert f.n_graphs == 0
    # the device's default generator is usable after the failed capture
    assert torch.randn(3, device=cuda).isfinite().all()


class _Cycle:
    """An object in a reference cycle that owns a captured graph (as an
    ``SDPipeline`` and its jits do): only the cyclic collector frees it."""

    def __init__(self, device):
        self.me = self
        self.jit = J.jit(lambda x: x + 1, name="owned")
        self.jit(torch.ones(4, device=device))


@pytest.mark.cuda
def test_a_collection_cannot_free_a_graph_during_a_capture(cuda):
    """Garbage that owns a graph is freed after a capture, not inside it:
    the captured function drops the last reference to such a cycle, sets
    the collector's thresholds to their lowest and allocates enough Python
    objects to start it many times over."""
    holder = [_Cycle(cuda)]
    thresholds = gc.get_threshold()

    def churn(x):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()                 # the cycle is garbage now
            gc.set_threshold(1, 1, 1)
            for _ in range(10000):
                [[]]                       # a container: counted by gc
        return x * 2
    try:
        f = J.jit(churn, name="churn")
        assert torch.equal(f(torch.ones(4, device=cuda)),
                           torch.full((4,), 2.0, device=cuda))
    finally:
        gc.set_threshold(*thresholds)
    assert f.n_graphs == 1 and not holder
    gc.collect()


@pytest.mark.cuda
def test_one_compiled_predict_on_the_card_equals_eager(cuda):
    """A small bf16 VAE-codec predictor with the native refiner (K1 and K2
    inside the graph), compiled and eager on the same frames."""
    vae = build(AutoencoderKL, VAEConfig(block_out_channels=(32, 64),
                                         layers_per_block=1,
                                         norm_num_groups=8), cuda,
                torch.bfloat16, seed=0)
    unet = build(UNet2DCondition, UNetConfig(
        block_out_channels=(32, 64), layers_per_block=1, attention_heads=2,
        cross_attention_dim=32, norm_num_groups=8), cuda, torch.bfloat16,
        seed=1)
    clip = build(CLIPTextEncoder, CLIPTextConfig(
        hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64),
        cuda, torch.bfloat16, seed=2)
    codec = VAECodec(32, vae)
    model = build(FrameTransformer, FrameTransformerConfig(
        latent_dim=codec.latent_dim, dim_model=64, num_heads=4,
        num_encoder_layers=1, num_decoder_layers=2, dim_feedforward=64),
        cuda, torch.bfloat16, seed=3)
    refiner = make_denoise_refiner(SDPipeline(vae, unet, clip), 32, 48, 50,
                                   hi_res=None)
    predict = make_predict_fn(model, codec, 3, window=5, refiner=refiner)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 5, 32, 32, 3), dtype=np.uint8))
    with launch_window() as compiled_w:
        a = predict(frames)
    held = [x.clone() for x in a]
    predict(frames.flip(0))
    with J.disable_jit(), launch_window() as eager_w:
        b = predict(frames)
    assert predict.impl.n_graphs == 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, h) for x, h in zip(a, held))
    assert (compiled_w.launches, compiled_w.bodies, compiled_w.gn_bodies) \
        == (eager_w.launches, eager_w.bodies, eager_w.gn_bodies)
    assert compiled_w.launches["flash_attention"] > 0
    assert compiled_w.gn_bodies == {"nhwc": compiled_w.launches[
        "groupnorm_silu"]}


@pytest.mark.cuda
def test_compiled_train_steps_on_the_card_equal_eager(cuda):
    """A small f32 VAE-codec step with dropout on (K1 and K2 in the frozen
    encode inside the graph): 3 compiled steps (the first the warm-up, then
    replays of one graph) against 3 eager ones from the same weights:
    loss components, parameters and both moments bit for bit, and a
    replay's launches by body an eager step's."""
    vae = build(AutoencoderKL, VAEConfig(block_out_channels=(32, 64),
                                         layers_per_block=1,
                                         norm_num_groups=8), cuda, seed=0)
    codec = VAECodec(16, vae)
    cfg = Config(lr=1e-3, batch_size=2, frames_per_clip=3,
                 frames_to_predict=2, frame_size=16, dropout_p=0.1)
    ft = FrameTransformerConfig(latent_dim=codec.latent_dim, dim_model=64,
                                num_heads=4, num_encoder_layers=1,
                                num_decoder_layers=2, dim_feedforward=64,
                                dropout_p=0.1, frames_to_predict=2)
    frames = [np.random.default_rng(s).integers(0, 256, (2, 3, 16, 16, 3),
                                                dtype=np.uint8)
              for s in range(3)]
    runs = []
    for eager in (False, True):
        model = build(FrameTransformer, ft, cuda, seed=1, trainable=True)
        init_fn, step_fn = make_train_step(
            model, codec, LossWeights.from_config(cfg), cfg)
        state = init_fn()
        comps, windows = [], []
        for f in frames:
            with (J.disable_jit() if eager else contextlib.nullcontext()), \
                    launch_window() as w:
                comps.append(step_fn(state, f, 0)[1])
            windows.append((w.launches, w.bodies, w.gn_bodies))
        runs.append((comps, windows, state, step_fn))
    (c_comps, c_win, c_state, c_fn), (e_comps, e_win, e_state, _) = runs
    assert c_fn.impl.n_graphs == 1 and c_state.step == e_state.step == 3
    for a, b in zip(c_comps, e_comps):
        assert all(torch.equal(a[k], b[k]) for k in b)
    sa, sb = c_state.state_dict(), e_state.state_dict()
    for tree in ("params", "mu", "nu"):
        assert all(torch.equal(v, sb[tree][k]) for k, v in sa[tree].items())
    assert c_win == e_win and c_win[0][0]["flash_attention"] > 0
    assert c_win[-1][2] == {"nhwc": c_win[-1][0]["groupnorm_silu"]}
