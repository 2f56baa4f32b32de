"""The port's benchmark (``sd_video_gen_tpu_torch/bench.py``) on the CPU at
tiny widths, against the JAX bench (``bench.py``) where they share a
definition.

Tolerances: none. Scenario names, order and baselines are equal; the
train-FLOPs formula equals the JAX bench's to the last bit; the frames a
refiner scenario times equal the predict entry point's bit for bit (the
same models, inputs and noise on one device); the FLOP counts equal hand
counts exactly (integer products of the shapes).
"""

import collections
import importlib
import json
import sys

import numpy as np
import pytest
import torch

from sd_video_gen_tpu_torch import bench as B
from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import CLIPTextConfig
from sd_video_gen_tpu_torch.models.unet import UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.predict.predict import make_predict_fn
from sd_video_gen_tpu_torch.tools import bench_harness as H

# The VAE downsamples 8x, as SD's does: the pixel codec's latent grid and
# the training paths' latent width assume it.
TINY = B.Sizes(
    vae=VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                  norm_num_groups=2),
    unet=UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                    attention_heads=2, cross_attention_dim=16,
                    norm_num_groups=2),
    clip=CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_length=8),
    flagship=dict(dim_model=32, num_heads=4, num_encoder_layers=1,
                  num_decoder_layers=2, dim_feedforward=48),
    frame=16, hi_res=32, train_frame=16,
    train_dims=dict(dim_model=32, num_heads=2, num_encoder_layers=1,
                    num_decoder_layers=2),
    max_batch=2)
RECORD_KEYS = {
    "scenario", "value", "unit", "vs_baseline", "q1", "q3", "best", "spread",
    "tries", "precision", "batch", "items_per_request", "wall_s_median",
    "walls_s", "checksum", "launches_per_request", "launches_implied",
    "launches_in_run", "flops_per_request", "flops_analytic", "mfu",
    "mfu_peak_flops", "mfu_peak_of", "wrapper_host_us", "card", "device",
    "flop_count_s", "seconds", "compiled", "compile_s", "replay_ms",
    *B.DEVICE_FIELDS}


@pytest.fixture(scope="module")
def jax_bench():
    """The repository's JAX bench, imported as test_bench_consistency does
    (its scenario filter read from an empty environment variable)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SDVG_BENCH_SCENARIOS", "")
    sys.modules.pop("bench", None)
    try:
        yield importlib.import_module("bench")
    finally:
        mp.undo()


def _lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_scenarios_and_baselines_are_the_jax_benchs(jax_bench):
    assert [n for n, _ in B.SCENARIOS] == [n for n, _ in jax_bench.SCENARIOS]
    assert B.BASELINES == jax_bench.BASELINES
    assert B.select([]) == [n for n, _ in B.SCENARIOS]


@pytest.mark.parametrize("args", [
    (6, 11, 10), (288, 11, 10), (64, 6, 5),
    (3, 7, 4, 256, 512, 6, 6, 1024), (1, 2, 1, 32, 48, 1, 2, 16)])
def test_train_flops_formula_is_the_jax_benchs(jax_bench, args):
    assert B.flagship_train_flops(*args) == \
        jax_bench._flagship_train_flops(*args)


@pytest.mark.parametrize("sampler,solver_steps",
                         [("ddim", None), ("dpmpp", 5)])
def test_refiner_scenario_times_what_predict_serves(sampler, solver_steps):
    """The frames a refiner scenario times are the predict entry point's
    (``make_predict_fn`` over the same models, then the codec's decode of
    the predicted latents), bit for bit, and its checksum is their sum."""
    wl = B.scenario_denoise(2, sampler, solver_steps, sizes=TINY,
                            device="cpu")
    reply = wl.request()
    m = wl.keep["models"]
    codec = VAECodec(TINY.frame, m["vae"])
    refiner = make_denoise_refiner(
        SDPipeline(m["vae"], m["unet"], m["clip"]), TINY.frame, 40, 50,
        TINY.hi_res, sampler=sampler, solver_steps=solver_steps)
    predict = make_predict_fn(m["ar"], codec, 4, window=H.CONTEXT,
                              refiner=refiner)
    _, preds = predict(wl.keep["frames"].numpy())
    with torch.inference_mode():
        want = codec.decode_latents(preds.reshape(-1, preds.shape[-1]))
    assert reply.out.dtype == torch.uint8
    assert reply.out.shape == (2 * 4, TINY.frame, TINY.frame, 3)
    assert torch.equal(reply.out, want)
    assert reply.checksum == int(want.long().sum())
    assert reply.finite and wl.request().checksum == reply.checksum


def test_flop_count_of_vae_attention_equals_hand_count():
    """One VAE attention block: four (C, C) products per token and the two
    (T, T) attention products, which the counter sees through the plain
    version (``force_reference``)."""
    cfg = VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                    norm_num_groups=2)
    block = build(AutoencoderKL, cfg, "cpu").decoder.mid_block.attentions[0]
    b, c, h, w = 3, 16, 4, 5
    x = torch.randn(b, c, h, w).contiguous(memory_format=torch.channels_last)
    t = h * w
    with torch.no_grad():
        got = B.count_flops(lambda: block(x))
    assert got == 4 * 2 * b * t * c * c + 2 * 2 * b * t * t * c


def test_flop_count_of_train_step_equals_hand_count():
    """One train_flagship step at tiny widths: the analytic formula of the
    JAX bench, less the input projection's input gradient (the frames need
    none), plus the cross-attention's keys and values over the source's one
    more token in every decoder layer and the NCE loss's three (M, P, P, C)
    products (two forward directions, one backward: the target is
    detached). The same terms make the +1.18% TRAIN_FLOPS_RTOL allows at
    full width."""
    wl = B.scenario_train(sizes=TINY, device="cpu")
    trainer = wl.keep["trainer"]
    cfg, mc = trainer.cfg, trainer.model_cfg
    b, L, d = cfg.batch_size, mc.latent_dim, mc.dim_model
    k = cfg.frames_to_predict
    t_tgt = cfg.frames_per_clip + k
    t_src = t_tgt + 1
    formula = B.flagship_train_flops(
        b, t_src, t_tgt, d, mc.dim_feedforward, mc.num_encoder_layers,
        mc.num_decoder_layers, L)
    M, P, C = b * k, L // 4, 4
    hand = (formula - 2 * b * (t_src + t_tgt) * L * d
            + 3 * 2 * b * (t_src - t_tgt) * 2 * d * d
            * mc.num_decoder_layers
            + 3 * 2 * M * P * P * C)
    assert B.count_flops(wl.probe) == hand
    assert wl.analytic_flops == H.TRAIN_TIMED * formula
    assert abs(hand / formula - 1) < B.TRAIN_FLOPS_RTOL
    # the same terms at the flagship's widths: what the card counts
    full = B.flagship_train_flops(6, 11, 10)
    assert (full - 2 * 6 * 21 * 1024 * 2048 + 12 * 6 * 2048 ** 2 * 8
            + 6 * 30 * 256 ** 2 * 4) * H.TRAIN_TIMED == 1322022076416


def test_records_and_the_aggregate_after_every_scenario(capsys):
    rc = B.main(["--device", "cpu"], sizes=TINY)
    lines = _lines(capsys.readouterr().out)
    assert rc == 0
    names = [n for n, _ in B.SCENARIOS]
    records = [r for r in lines if "scenario" in r]
    assert [r["scenario"] for r in records] == names
    # on the CPU each record is followed by the aggregate of all so far
    assert len(lines) == 2 * len(names)
    for i, (rec, agg) in enumerate(zip(lines[::2], lines[1::2])):
        assert set(rec) == RECORD_KEYS
        assert list(agg) == ["metric", "value", "unit", "vs_baseline",
                             "scenarios"]
        assert list(agg["scenarios"]) == names[:i + 1]
        assert agg["scenarios"][rec["scenario"]] == {
            k: v for k, v in rec.items() if k != "scenario"}
        assert rec["tries"] == B.REPEATS and len(rec["walls_s"]) == B.REPEATS
        assert rec["q1"] <= rec["value"] <= rec["q3"] <= rec["best"]
        assert rec["spread"] >= 0
        assert rec["vs_baseline"] == rec["value"] / B.BASELINES[
            rec["scenario"]]
        assert rec["flops_per_request"] > 0
        # nothing here is a device number
        assert rec["device"] == "cpu" and rec["card"] is None
        # the CPU runs the request as it is: no graph, no replay
        assert (rec["compiled"], rec["compile_s"], rec["replay_ms"]) == (
            False, 0, None)
        assert rec["mfu"] is None and rec["wrapper_host_us"] is None
        assert all(rec[k] is None for k in B.DEVICE_FIELDS)
        # the CPU takes the plain versions: no launch, whatever the path
        assert rec["launches_in_run"] == {"flash_attention": {},
                                          "groupnorm_silu": {}}
        vae = rec["scenario"].startswith("vae") or rec["scenario"] == \
            "train_ref_artifact"
        assert (min(rec["launches_implied"].values()) > 0) == vae
        assert (max(rec["launches_implied"].values()) > 0) == vae
        assert rec["mfu_peak_of"] == rec["precision"]
    by_name = {r["scenario"]: r for r in records}
    assert by_name["pixel_ar16_kvcache_int8"]["precision"] == "int8"
    assert by_name["train_ref_artifact"]["precision"] == "f32"
    assert by_name["train_flagship"]["unit"] == "steps/sec/chip"
    assert lines[-1]["metric"] == B.PRIMARY_METRIC
    assert lines[-1]["value"] == by_name["vae_denoise_ar4_8streams"]["value"]


def test_a_failing_scenario_lets_the_others_run(capsys, monkeypatch):
    def boom(sizes=B.FULL, device="cuda"):
        raise RuntimeError("no such model")

    monkeypatch.setattr(B, "SCENARIOS", [
        ("pixel_ar16", B.scenario_pixel), ("boom", boom),
        ("train_flagship", B.scenario_train)])
    rc = B.main(["--device", "cpu"], sizes=TINY)
    lines = _lines(capsys.readouterr().out)
    assert rc == 1
    assert [r.get("scenario") for r in lines] == [
        "pixel_ar16", None, "boom", "train_flagship", None]
    assert "RuntimeError: no such model" in lines[2]["error"]
    assert lines[-1]["metric"] == "fallback_pixel_ar16"
    assert list(lines[-1]["scenarios"]) == ["pixel_ar16", "train_flagship"]


def test_without_cuda_it_refuses_and_names_the_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "NVIDIA GPU" in out.err and "--device cpu" in out.err


def test_select_by_name_prefix_and_environment(capsys, monkeypatch):
    assert B.select(["train"]) == ["train_flagship", "train_flagship_tuned",
                                   "train_ref_artifact"]
    assert B.select(["vae_ar16", "pixel_ar16_kvcache"]) == [
        "pixel_ar16_kvcache", "pixel_ar16_kvcache_int8", "vae_ar16"]
    with pytest.raises(SystemExit, match="no scenario matches"):
        B.select(["nope"])
    monkeypatch.setenv("SDVG_BENCH_SCENARIOS", "train_ref")
    assert B.main(["--device", "cpu"], sizes=TINY) == 0
    names = [r["scenario"] for r in _lines(capsys.readouterr().out)
             if "scenario" in r]
    assert names == ["train_ref_artifact"]


def test_device_breakdown_buckets_by_kernel_name():
    Event = collections.namedtuple("Event",
                                   "key count self_device_time_total")
    events = [Event("flash_fwd_wgmma<128>", 10, 3000.0),
              Event("gn_nhwc_cluster", 20, 2000.0),
              Event("sm90_xmma_fprop_implicit_gemm_bf16", 5, 4000.0),
              Event("Memcpy HtoD (Pageable -> Device)", 2, 500.0),
              Event("void at::native::vectorized_elementwise_kernel", 7,
                    250.0),
              Event("some_kernel", 1, 250.0),
              Event("cudaLaunchKernel", 40, 0.0)]
    d = H.device_breakdown(events)
    assert d["ms"] == 10.0 and d["kernels"] == 45
    assert d["buckets"] == {"convolutions": 4.0, "K1 flash attention": 3.0,
                            "K2 GroupNorm+SiLU": 2.0, "copies / cat": 0.5,
                            "elementwise": 0.25, "other": 0.25}
    assert list(d["buckets"])[0] == "convolutions"
    with pytest.raises(AssertionError, match="no device time"):
        H.device_breakdown(events[-1:])


def test_sizes_default_to_full_width():
    assert B.FULL == B.Sizes()
    assert B.FULL.vae == VAEConfig() and B.FULL.unet == UNetConfig()
    assert B.FULL.clip == CLIPTextConfig()
    assert B.FULL.flagship == H.FLAGSHIP == dict(
        dim_model=2048, num_heads=8, num_encoder_layers=4,
        num_decoder_layers=8)
    assert (B.FULL.frame, B.FULL.hi_res, B.FULL.train_frame) == (64, 512, 128)
    assert B.FULL.train_dims is None and B.FULL.max_batch is None
    assert B.FULL.batch(288) == 288 and TINY.batch(288) == 2
    sizes = {p["name"]: (p["batch_clips"], p["pred"]) for p in H.PATHS}
    assert sizes["pixel_ar16"] == (256, 16) and sizes["vae_ar16"] == (32, 16)
    assert sizes["vae_denoise_ar4"] == (1, 4)
    assert {p["name"]: p["cfg"].batch_size for p in H.TRAIN_PATHS} == {
        "train_flagship": 6, "train_flagship_tuned": 288,
        "train_ref_artifact": 64}
    assert np.isclose(H.MFU_PEAKS["f32"], 164.9e12)


def test_launches_the_full_width_models_imply():
    """Per request, from the SD-v1.4 models' structure (built on the meta
    device: no weights): what the card counted in every scenario."""
    models = H.build_models("meta", torch.bfloat16, VAEConfig(), UNetConfig(),
                            CLIPTextConfig(), H.FLAGSHIP, H.FRAME)
    ddim = B._path("vae_denoise_ar4")
    want = {"vae_denoise_ar4": (658, 2908), "vae_ar16": (2, 52),
            "vae_denoise_ar4_8streams_dpmpp5": (338, 1688),
            "pixel_ar16_kvcache": (0, 0)}
    for name, (k1, k2) in want.items():
        path = ddim if name == "vae_denoise_ar4" else B._path(name)
        assert H.expected_launches(models, path, 1) == {
            "flash_attention": k1, "groupnorm_silu": k2}, name
    # 8 streams: the same launches at any batch
    assert H.expected_launches(models, dict(ddim, batch_clips=8), 3) == {
        "flash_attention": 3 * 658, "groupnorm_silu": 3 * 2908}
    # a training step's frozen VAE encode
    assert H.passes_per_model(dict(vae=models["vae"], unet=None)) == {
        "flash_attention": (1, 1, 0), "groupnorm_silu": (22, 30, 0)}
