"""The port's compiled programs (``utils/jit.py``) on the card.

Every test here carries the ``cuda`` marker and skips without a GPU: a CUDA
graph is captured on the card only. Torch only, so it runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jit_cuda.py -m cuda

A compiled request runs the same kernels on the same inputs as the eager
one: equal bit for bit, with the same launches by body.
"""

import numpy as np
import pytest
import torch

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
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn
from sd_video_gen_tpu_torch.tools.bench_harness import launch_window
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
