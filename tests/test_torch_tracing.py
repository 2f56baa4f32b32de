"""The port's tracing (``sd_video_gen_tpu_torch/utils/profiling.py``): host
spans, device stage marks and the operator's exporter.

On the CPU: a span that is off costs a check and records nothing; spans that
are on land in the profiler's events with their parents; a request and a
training step mark their stages in the order the benchmark's readers count
(``profiling.mark`` swapped for a recorder: off the card a mark launches
nothing); the server's spans run on its own thread, which a profiler started
after it sees only where it records every thread (``profiling.trace``).
On the card (``cuda`` marker): each mark is one kernel named
``sdvg_mark_<stage>``, also inside a captured graph's replay, and the
launch accounting does not count it. This file imports torch only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m cuda
"""

import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.utils import jit as J
from sd_video_gen_tpu_torch.utils import profiling

TINY_VAE = dict(block_out_channels=(16, 32), layers_per_block=1,
                norm_num_groups=8)
TINY_UNET = dict(block_out_channels=(16, 32), layers_per_block=1,
                 attention_heads=2, cross_attention_dim=16, norm_num_groups=8)
TINY_CLIP = dict(hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32)
TINY_FT = dict(dim_model=32, num_heads=2, num_encoder_layers=1,
               num_decoder_layers=1, dim_feedforward=64)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def marks(monkeypatch):
    """Every stage ``profiling.mark`` is asked for, in order."""
    seen = []
    monkeypatch.setattr(profiling, "mark",
                        lambda stage, device: seen.append(stage))
    return seen


def _named(prof, name):
    return [e for e in prof.events() if e.name == name]


# -- spans ---------------------------------------------------------------------

def test_a_span_that_is_off_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("a range was opened with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = profiling.span("a")
    assert off is profiling.span("b")            # one shared context
    with off, profiling.span("c"):
        torch.ones(2).sum()


def test_spans_that_are_on_appear_nested_in_the_profilers_events():
    f = J.jit(lambda x: x + 1, name="plus_one")  # CPU tensors: eager
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(2).sum()
            f(torch.zeros(3))
    (outer,), (inner,), (call,) = (_named(prof, n) for n in
                                   ("outer", "inner", "jit.plus_one"))
    assert inner.cpu_parent is outer and call.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


# -- stage marks -----------------------------------------------------------------

def test_a_mark_names_a_known_stage_and_does_nothing_off_the_card(
        monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded off the card")
    monkeypatch.setattr(_kernels, "library", refuse)
    for stage in profiling.STAGES:
        profiling.mark(stage, torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown stage"):
        profiling.mark("decode", torch.device("cpu"))


def _tiny_served(pred_frames: int):
    """The refined serving path (VAE codec, 2x-upscaled refiner, AR rollout)
    at tiny widths on the CPU: (predict, decode)."""
    from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
    from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
    from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextEncoder)
    from sd_video_gen_tpu_torch.models.transformer import (
        FrameTransformer, FrameTransformerConfig)
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from sd_video_gen_tpu_torch.predict.predict import (make_decode_fn,
                                                        make_predict_fn)
    vae = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu", seed=1)
    unet = build(UNet2DCondition, UNetConfig(**TINY_UNET), "cpu", seed=2)
    clip = build(CLIPTextEncoder, CLIPTextConfig(**TINY_CLIP), "cpu", seed=3)
    codec = VAECodec(16, vae)
    model = build(FrameTransformer, FrameTransformerConfig(
        latent_dim=codec.latent_dim, **TINY_FT), "cpu", seed=4)
    refine = make_denoise_refiner(SDPipeline(vae, unet, clip), 16, 40, 50,
                                  hi_res=32)
    return (make_predict_fn(model, codec, pred_frames, window=3, mode="ar",
                            refiner=refine), make_decode_fn(codec))


def test_a_request_marks_its_stages_in_order(marks):
    predict, decode = _tiny_served(pred_frames=2)
    frames = np.random.default_rng(0).integers(0, 256, (1, 3, 16, 16, 3),
                                               dtype=np.uint8)
    with torch.inference_mode():
        context, preds = predict(torch.from_numpy(frames))
    assert marks == ["vae"] + ["rollout", "vae", "unet", "vae"] * 2 + ["end"]
    del marks[:]
    decode(preds.reshape(-1, preds.shape[-1]))
    assert marks == ["vae", "end"]


def _tiny_trainer(workdir: str):
    from sd_video_gen_tpu_torch.config import Config
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    c = Config(config_name="tiny", batch_size=2, frames_per_clip=3,
               frames_to_predict=2, frame_size=32, dim_model=32, num_heads=2,
               num_encoder_layers=1, num_decoder_layers=1)
    trainer = Trainer(c, mode="ar", codec_kind="pixel",
                      checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      log_dir=os.path.join(workdir, "logs"), use_wandb=False,
                      device="cpu")
    trainer.logger.quiet = True
    trainer.init_state(seed=0)
    return trainer


def test_a_train_step_marks_its_stages_and_nests_its_spans(marks, tmp_path):
    trainer = _tiny_trainer(str(tmp_path))
    batch = np.random.default_rng(1).integers(0, 256, (2, 5, 32, 32, 3),
                                              dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = trainer.train_loop([([0, 1], batch)], seed=3)
    assert marks == ["forward", "backward", "optimizer", "end"]
    (step,) = _named(prof, "train.step")
    for child in ("train.feed", "jit.step_impl", "train.losses"):
        (span,) = _named(prof, child)
        assert span.cpu_parent is step, child
    assert out["steps_timed"] == 1 and np.isfinite(out["total_train"])


# -- the server's spans and the exporter -----------------------------------------

def _stub_server(sock: str):
    """``serve`` in a thread over stand-in programs at 1 clip of 2 8px
    frames; returns the thread once the server answers."""
    from sd_video_gen_tpu_torch.predict import serve as S

    def predict(frames, text_embeds=None):
        x = torch.from_numpy(np.array(frames, np.float32)).flatten(2)[..., :4]
        return x, x[:, -1:] + 1

    def decode(latents):
        return torch.zeros((latents.shape[0], 8, 8, 3), dtype=torch.uint8)

    thread = threading.Thread(target=S.serve, args=(sock, predict, decode),
                              kwargs=dict(batch_clips=1, frames_per_clip=2,
                                          frame_size=8), daemon=True)
    thread.start()
    S.wait_ready(sock, deadline_s=60.0, poll_s=0.02)
    return thread


def test_a_round_trip_shows_the_servers_spans_only_under_the_exporter():
    from sd_video_gen_tpu_torch.predict import serve as S
    frames = np.zeros((1, 2, 8, 8, 3), np.uint8)
    server_spans = {"serve.recv", "serve.run", "serve.send"}
    with tempfile.TemporaryDirectory(prefix="sdvg-") as d:
        sock = os.path.join(d, "s.sock")
        thread = _stub_server(sock)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                imgs, is_pred, _ = S.request(sock, frames)
            names = {e.name for e in prof.events()}
            assert "serve.request" in names and not names & server_spans
            assert imgs.shape == (1, 2, 8, 8, 3) and is_pred == [False, True]
            with profiling.trace(os.path.join(d, "tr")) as logdir:
                S.request(sock, frames)
        finally:
            S.shutdown(sock)
            thread.join(timeout=30)
        assert not thread.is_alive()
        with open(os.path.join(logdir, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert server_spans | {"serve.request"} <= names


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a stage mark is a CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_each_mark_is_one_uncounted_kernel_also_in_a_graphs_replay(cuda):
    x = torch.zeros(4, device=cuda)

    def body(x):
        profiling.mark("forward", x.device)
        y = x + 1
        profiling.mark("end", y.device)
        return y

    launches = dict(_kernels.LAUNCHES)
    for stage in profiling.STAGES:                 # builds the library
        profiling.mark(stage, cuda)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(x)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = body(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for stage in profiling.STAGES:
            profiling.mark(stage, cuda)
        graph.replay()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith("sdvg_mark_")]
    assert kernels == [f"sdvg_mark_{s}" for s in profiling.STAGES] + [
        "sdvg_mark_forward", "sdvg_mark_end"]
    assert torch.equal(out, x + 1)
    assert dict(_kernels.LAUNCHES) == launches
