"""Benchmark: the JAX bench's ten scenarios (``bench.py``) through the port,
on one NVIDIA GPU.

    python -m sd_video_gen_tpu_torch.bench [--scenario NAME ...] [--device cpu]

The scenarios keep ``bench.py``'s names, order and sizes (their sizes are
``tools/bench_harness.py``'s, which ``chip_smoke.py`` drives too):

  pixel_ar16        256 clips, 16 frames predicted by the flagship
                    FrameTransformer's full rollout, PixelCodec, bf16
                    (``SDVG_BENCH_INT8=1``: its int8 weights)
  vae_denoise_ar4_8streams / vae_denoise_ar4
                    8 clips / 1 clip, the SD VAE codec, 4 frames, each
                    refined at 512px by 10 DDIM steps of the SD UNet from
                    ``timesteps[40]``, bf16
  pixel_ar16_kvcache / _int8
                    as ``pixel_ar16`` over the KV-cached rollout, bf16 / int8
  vae_ar16          32 clips (``SDVG_BENCH_VAE_BATCH``), the VAE codec, 16
                    frames, no refiner, bf16
  train_flagship / train_flagship_tuned
                    ``Trainer.train_loop`` at batch 6 / 288
                    (``SDVG_BENCH_TRAIN_TUNED_BATCH``): 5 + 5 frames of
                    128px, dim 2048, 4 + 8 layers, MSE + GDL + NCE,
                    ``bf16_full``
  train_ref_artifact
                    batch 64, 5 frames of 128px, the f32 SD VAE encoding the
                    batch inside every step, dim 256, 6 + 6 layers, MSE +
                    GDL, f32
  vae_denoise_ar4_8streams_dpmpp5
                    as the 8-stream scenario with DPM-Solver++ in 5 calls

A serving request is what ``bench.py:306-316`` times: the VAE (or pixel)
encode with SOS, the rollout with its refiner, the final decode of the
predicted latents, and a device-side sum of the uint8 frames fetched to the
host as the sync. As the JAX bench jits it, the request is one compiled
program (``utils/jit.py``: one CUDA graph, captured in the warm-up, whose
seconds each scenario prints on a ``compiles`` line before its record;
``replay_ms``, the median device time of the timed replays from CUDA events
around them); ``--eager`` runs every scenario eagerly instead (the
comparison of the two). A training request, eager, is ``TRAIN_TIMED``
optimizer steps through ``Trainer.train_loop`` on one fixed batch (its
frames cross to the card every step, as from a loader), from the state the
scenario started with.

Each scenario is built, run once to warm up, timed over ``REPEATS`` requests
(each closed by ``torch.cuda.synchronize``), and freed before the next. Its
record gives the median rate as ``value``, with ``q1``, ``q3``, ``best``
(the JAX bench's statistic), ``spread`` = (max - min) / median and
``tries``. The checks: every repeat's checksum (the frames' sum, or the
losses bit for bit) equals the warm-up's; outputs are finite; each kernel's
launches equal what the models' structure implies (``expected_launches``);
every flash attention launch took the body its dtype routes to (``wgmma``
for bf16, ``tf32x3`` for f32) and every GroupNorm launch the ``nhwc`` body.

``mfu``: the useful FLOPs of a request, counted once outside the timed
requests by ``torch.utils.flop_counter.FlopCounterMode`` with
``_kernels.force_reference`` on (the counter cannot see the CUDA kernels,
which it would leave out; their plain versions' products it counts), over
the median wall times the card's peak for the scenario's precision
(``bench_harness.MFU_PEAKS``).

Device time: once every untraced timing of the run is taken, each scenario
is built again, warmed up, and one request runs under ``torch.profiler``
(after a trace, every later launch of the process costs the host more, so no
untraced timing follows the first trace). Its kernels and copies give
``device_ms``, ``device_idle_share`` = 1 - ``device_ms`` / the median wall,
K1's and K2's ms and every bucket's (``bench_harness.PROFILE_BUCKETS``). The
traced request's checksum must equal the untraced ones'.

Output: one JSON line per scenario (or its error), and after every scenario
the aggregate in ``bench.py``'s shape (``metric``, ``value``, ``unit``,
``vs_baseline``, ``scenarios``), so a run cut short still ends in one. The
exit code is non-zero if any selected scenario failed or was skipped.
``SDVG_BENCH_SCENARIOS`` (comma list) or ``--scenario`` picks a subset, by
name or prefix; ``SDVG_BENCH_BUDGET_S`` skips what would start after that
many seconds, ``SDVG_BENCH_HARD_S`` ends the process then, printing the
aggregate of what completed. Without CUDA the benchmark refuses to run
unless ``--device cpu`` is given; on the CPU nothing is a device number
(``mfu`` and the device fields are null).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch

from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.config import strict_f32
from sd_video_gen_tpu_torch.data.synthetic import _render_sequence
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.clip_text import CLIPTextConfig
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.tools import bench_harness as H
from sd_video_gen_tpu_torch.utils import jit as J

REPEATS = 5
# The JAX bench's denominators (bench.py:76-93), kept under the same name:
# op-level ESTIMATES of the reference's pipeline on an RTX 3090 for serving
# and the flagship training runs (BASELINE.md), and one MEASURED point,
# train_ref_artifact's 41.56 clips/s: the reference's own recorded W&B run
# r4f87l3x on its RTX 3090 (tools/reference_baseline.py). None is a number
# of the card this benchmark runs on.
BASELINES = {"pixel_ar16": 150.0, "pixel_ar16_kvcache": 150.0,
             "pixel_ar16_kvcache_int8": 150.0, "vae_ar16": 115.0,
             "vae_denoise_ar4": 0.9, "vae_denoise_ar4_8streams": 0.9,
             "vae_denoise_ar4_8streams_dpmpp5": 0.9,
             "train_ref_artifact": 41.56,
             "train_flagship": 10.0, "train_flagship_tuned": 60.0}
PRIMARY = ("vae_denoise_ar4_8streams", "vae_denoise_ar4")
PRIMARY_METRIC = "generated_frames_per_sec_64px_vae_denoise10_ar"
# The port's FLOP count of a train_flagship step against the analytic
# formula (``flagship_train_flops``, bench.py:319-336), relative. The formula
# takes every backward as twice its forward and the cross-attention's keys
# and values over the target's tokens. The port's input projection has no
# input gradient (the frames need none: -0.32% at the flagship's widths),
# each of the 8 decoder layers' cross-attention projects the source's one
# more token (+1.48%), and the NCE loss's products are outside the formula
# (+0.03%): +1.18% in all, which the card reads (1.3220e12 FLOPs a request
# of 8 steps). The CPU test holds the count to those terms exactly.
TRAIN_FLOPS_RTOL = 0.02


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths and batches of the scenarios; the defaults are full width.
    ``train_dims`` replaces the training paths' transformer widths and
    ``max_batch`` caps every batch (both None: the paths' own)."""
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    flagship: dict = dataclasses.field(
        default_factory=lambda: dict(H.FLAGSHIP))
    frame: int = H.FRAME
    hi_res: int = H.HI_RES
    train_frame: int = H.TRAIN_FRAME
    train_dims: dict | None = None
    max_batch: int | None = None

    def batch(self, b: int) -> int:
        return b if self.max_batch is None else min(b, self.max_batch)


FULL = Sizes()


class Reply(NamedTuple):
    out: object         # the frames (uint8) or the loop's loss means
    checksum: object    # what every repeat must reproduce exactly
    finite: bool        # latents or losses


@dataclasses.dataclass
class Workload:
    """One scenario, built: ``request()`` makes ``items`` frames, steps or
    clips; ``expected`` are its kernel launches on the card, from the
    models' structure; ``probe()`` does the work of ``1 /
    probe_per_request`` of a request (its FLOPs are counted); ``reset()``
    (training) returns to the state the scenario started from."""
    unit: str
    precision: str              # the MFU peak's: "bf16", "f32" or "int8"
    batch: int
    items: int
    request: Callable[[], Reply]
    expected: dict
    flash_body: str
    probe: Callable
    program: object = None      # the compiled request (serving), a jit
    probe_per_request: int = 1
    reset: Callable | None = None
    keep: dict = dataclasses.field(default_factory=dict)
    analytic_flops: float | None = None


def context_frames(batch: int, size: int) -> np.ndarray:
    """The JAX bench's context clips: bouncing balls from seed 0."""
    rng = np.random.default_rng(0)
    return np.stack([_render_sequence(H.CONTEXT, size, rng)
                     for _ in range(batch)])


def _path(name: str) -> dict:
    return next(p for p in H.PATHS if p["name"] == name)


def _serving(path: dict, sizes: Sizes, device) -> Workload:
    """Encode, rollout (and refiner), decode and the frames' sum of one
    batch of ``path``."""
    path = dict(path, batch_clips=sizes.batch(path["batch_clips"]))
    B, dev, bf16 = path["batch_clips"], torch.device(device), torch.bfloat16
    if path["codec"] == "vae" or path["refine"] is not None:
        models = H.build_models(dev, bf16, sizes.vae, sizes.unet, sizes.clip,
                                sizes.flagship, sizes.frame)
    else:   # the pixel codec: the transformer alone, on its latent width
        models = dict(device=dev, dtype=bf16, ar=build(
            FrameTransformer, FrameTransformerConfig(
                latent_dim=PixelCodec(sizes.frame, dev).latent_dim,
                **sizes.flagship), dev, bf16, seed=3))
    codec, predict = H.predict_fn(models, path, frame=sizes.frame,
                                  hi_res=sizes.hi_res)
    frames = torch.from_numpy(context_frames(B, sizes.frame)).to(dev)

    def run(frames):
        _, preds = predict(frames)
        out = codec.decode_latents(preds.reshape(-1, preds.shape[-1]))
        # int64, as 256 clips' sum passes 2^31
        return out, torch.stack([
            out.sum(dtype=torch.int64),
            torch.isfinite(preds).all().to(torch.int64)])

    program = J.jit(run, name=path["name"])

    def request() -> Reply:
        with torch.inference_mode():
            out, stats = program(frames)
            total, finite = stats.tolist()      # one fetch is the sync
        return Reply(out, total, bool(finite))

    return Workload(
        unit="frames/sec/chip", precision="int8" if path["int8"] else "bf16",
        batch=B, items=B * path["pred"], request=request,
        expected=H.expected_launches(models, path, 1), flash_body="wgmma",
        probe=request, program=program,
        keep=dict(models=models, frames=frames, path=path))


def scenario_pixel(sizes: Sizes = FULL, device="cuda") -> Workload:
    int8 = os.environ.get("SDVG_BENCH_INT8", "").lower() not in ("", "0",
                                                                 "false")
    return _serving(_path("pixel_ar16_int8" if int8 else "pixel_ar16"),
                    sizes, device)


def scenario_pixel_kvcache(int8: bool = False, sizes: Sizes = FULL,
                           device="cuda") -> Workload:
    return _serving(_path("pixel_ar16_kvcache_int8" if int8
                          else "pixel_ar16_kvcache"), sizes, device)


def scenario_vae(sizes: Sizes = FULL, device="cuda") -> Workload:
    path = _path("vae_ar16")
    batch = int(os.environ.get("SDVG_BENCH_VAE_BATCH", path["batch_clips"]))
    return _serving(dict(path, batch_clips=batch), sizes, device)


def scenario_denoise(batch: int = 1, sampler: str = "ddim",
                     solver_steps: int | None = None, sizes: Sizes = FULL,
                     device="cuda") -> Workload:
    path = _path("vae_denoise_ar4")
    name = (path["name"] + (f"_{batch}streams" if batch > 1 else "")
            + (f"_{sampler}{solver_steps}" if sampler != "ddim" else ""))
    return _serving(dict(path, name=name, batch_clips=batch, refine=dict(
        path["refine"], sampler=sampler, solver_steps=solver_steps)),
        sizes, device)


def _training(path: dict, sizes: Sizes, device, batch: int | None = None
              ) -> Workload:
    """``TRAIN_TIMED`` steps of ``Trainer.train_loop`` on one fixed batch,
    each request from the state the Trainer was built with."""
    cfg = path["cfg"].replace(
        batch_size=sizes.batch(batch or path["cfg"].batch_size),
        frame_size=sizes.train_frame, **(sizes.train_dims or {}))
    path = dict(path, cfg=cfg)
    workdir = tempfile.TemporaryDirectory(prefix="sdvg-bench")
    vae = (build(AutoencoderKL, sizes.vae, device)      # f32, seed 0
           if path["codec"] == "vae" else None)
    trainer = H.make_trainer(path, workdir.name, device=device, vae=vae)
    start = {tree: ({k: v.clone() for k, v in t.items()}
                    if isinstance(t, dict) else t)
             for tree, t in trainer.state.state_dict().items()}
    loader = [([0] * cfg.batch_size, H.train_frames(path))]

    def steps(n: int) -> Reply:
        means = trainer.train_loop(loader * n)
        losses = tuple(v for k, v in sorted(means.items())
                       if k.endswith("_train"))
        return Reply(means, losses, all(np.isfinite(losses)))

    # the frozen VAE's encode is the step's only kernel work
    per_step = ({k: v[0] for k, v in
                 H.passes_per_model(dict(vae=vae, unet=None)).items()}
                if vae is not None else dict.fromkeys(H.KERNELS, 0))
    analytic = None
    if path["name"] == "train_flagship":
        mc = trainer.model_cfg
        t_clip = cfg.frames_per_clip + cfg.frames_to_predict
        analytic = H.TRAIN_TIMED * flagship_train_flops(
            cfg.batch_size, t_clip + 1, t_clip, mc.dim_model,
            mc.dim_feedforward, mc.num_encoder_layers, mc.num_decoder_layers,
            mc.latent_dim)
    return Workload(
        unit="steps/sec/chip" if path["name"] == "train_flagship"
        else "clips/sec/chip",
        precision="f32" if path["precision"] == "f32" else "bf16",
        batch=cfg.batch_size,
        items=H.TRAIN_TIMED * (1 if path["name"] == "train_flagship"
                               else cfg.batch_size),
        request=lambda: steps(H.TRAIN_TIMED),
        expected={k: H.TRAIN_TIMED * n for k, n in per_step.items()},
        flash_body="tf32x3", probe=lambda: steps(1),
        probe_per_request=H.TRAIN_TIMED,
        reset=lambda: trainer.state.load_state_dict(start),
        keep=dict(trainer=trainer, workdir=workdir, path=path),
        analytic_flops=analytic)


def _train_path(name: str) -> dict:
    return next(p for p in H.TRAIN_PATHS if p["name"] == name)


def scenario_train(batch: int = 6, precision: str = "bf16_full",
                   sizes: Sizes = FULL, device="cuda") -> Workload:
    """``train_flagship`` at ``batch`` and the trainer's ``--precision``
    (``f32``, ``bf16`` or ``bf16_full``; the scenario's is ``bf16_full``),
    as ``bench.py``'s ``scenario_train(batch, precision)``."""
    return _training(dict(_train_path("train_flagship"), precision=precision),
                     sizes, device, batch)


def scenario_train_tuned(sizes: Sizes = FULL, device="cuda") -> Workload:
    batch = int(os.environ.get("SDVG_BENCH_TRAIN_TUNED_BATCH", 288))
    return _training(_train_path("train_flagship_tuned"), sizes, device,
                     batch)


def scenario_train_ref_artifact(sizes: Sizes = FULL,
                                device="cuda") -> Workload:
    return _training(_train_path("train_ref_artifact"), sizes, device)


def flagship_train_flops(batch, t_src, t_tgt, d=2048, dff=2048, n_enc=4,
                         n_dec=8, latent=1024):
    """Analytic FLOPs of one flagship train step (fwd + bwd ~= 3x fwd):
    matmul terms per token plus the attention score/value quadratics
    (``bench.py``'s ``_flagship_train_flops``)."""
    emb = latent * d
    enc_lin = 4 * d * d + 2 * d * dff          # qkv+out, ffn
    dec_lin = 8 * d * d + 2 * d * dff          # self + cross, ffn
    out = d * latent
    fwd = 2.0 * batch * (
        t_src * (n_enc * enc_lin + emb)
        + t_tgt * (n_dec * dec_lin + emb + out))
    attn = 2.0 * batch * d * 2 * (
        n_enc * t_src ** 2 + n_dec * (t_tgt ** 2 + t_tgt * t_src))
    return 3.0 * (fwd + attn)


# Names, order and sizes of bench.py:497-525.
SCENARIOS = [
    ("pixel_ar16", scenario_pixel),
    ("vae_denoise_ar4_8streams",
     lambda sizes=FULL, device="cuda": scenario_denoise(8, sizes=sizes,
                                                        device=device)),
    ("vae_denoise_ar4", scenario_denoise),
    ("pixel_ar16_kvcache", scenario_pixel_kvcache),
    ("pixel_ar16_kvcache_int8",
     lambda sizes=FULL, device="cuda": scenario_pixel_kvcache(
         True, sizes=sizes, device=device)),
    ("vae_ar16", scenario_vae),
    ("train_flagship", scenario_train),
    ("train_flagship_tuned", scenario_train_tuned),
    ("train_ref_artifact", scenario_train_ref_artifact),
    ("vae_denoise_ar4_8streams_dpmpp5",
     lambda sizes=FULL, device="cuda": scenario_denoise(
         8, "dpmpp", 5, sizes=sizes, device=device)),
]


def count_flops(fn) -> int:
    """FLOPs of ``fn()``'s products (matmuls, convolutions, int8 matmuls),
    with the kernels' plain versions standing in for the kernels, whose
    work the counter cannot see."""
    from torch.utils.flop_counter import FlopCounterMode

    def int_mm(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]

    with _kernels.force_reference(), FlopCounterMode(
            display=False,
            custom_mapping={torch.ops.aten._int_mm: int_mm}) as counter:
        fn()
    return counter.get_total_flops()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(wl: Workload, device) -> tuple[float, Reply]:
    if wl.reset is not None:
        wl.reset()
    _sync(device)
    t0 = time.perf_counter()
    reply = wl.request()
    _sync(device)
    return time.perf_counter() - t0, reply


def _bodies(window) -> dict:
    """A launch window's launches of each kernel by body."""
    return {"flash_attention": dict(window.bodies),
            "groupnorm_silu": dict(window.gn_bodies)}


def _expected(wl: Workload, device, requests: int) -> dict:
    """What a window of ``requests`` must count: the structure's launches
    on the card; none on the CPU, where the plain versions run."""
    on_card = torch.device(device).type == "cuda"
    return {k: n * requests * on_card for k, n in wl.expected.items()}


def time_requests(name: str, wl: Workload, device, repeats: int) -> dict:
    """Warm-up and ``repeats`` timed requests (one launch window, checked):
    the rate's median, quartiles and spread, the checksum and the
    launches."""
    walls, replies, replay_ms = [], [], []
    n_compiles = len(J.COMPILES)
    with H.launch_window() as window:
        for _ in range(1 + repeats):
            wall, reply = _timed(wl, device)
            walls.append(wall)
            replies.append(reply)
            if wl.program is not None:
                replay_ms.append(wl.program.replay_ms())
    window.check(name, _expected(wl, device, 1 + repeats), wl.flash_body)
    compiles = [dict(shapes=c["shapes"], warmup_s=c["warmup_s"],
                     capture_s=c["capture_s"])
                for c in J.COMPILES[n_compiles:]]
    if compiles:
        emit({"scenario": name, "compiles": compiles})
    if not all(r.finite for r in replies):
        raise AssertionError(f"{name}: non-finite outputs")
    sums = [r.checksum for r in replies]
    if any(s != sums[0] for s in sums[1:]):
        raise AssertionError(f"{name}: the repeats' checksums differ from "
                             f"the warm-up's: {sums}")
    walls = walls[1:]
    rates = sorted(wl.items / w for w in walls)
    median = statistics.median(rates)
    requests = 1 + repeats
    return dict(
        value=median, unit=wl.unit,
        q1=float(np.percentile(rates, 25)), q3=float(np.percentile(rates, 75)),
        best=rates[-1], spread=(rates[-1] - rates[0]) / median,
        tries=len(rates), precision=wl.precision, batch=wl.batch,
        items_per_request=wl.items, wall_s_median=statistics.median(walls),
        walls_s=walls, checksum=sums[0],
        compiled=wl.program is not None and wl.program.n_graphs > 0,
        compile_s=sum(c["warmup_s"] + c["capture_s"] for c in compiles),
        replay_ms=(statistics.median(replay_ms[1:])
                   if replay_ms and replay_ms[-1] is not None else None),
        launches_per_request={k: {b: n / requests for b, n in v.items()}
                              for k, v in _bodies(window).items()},
        launches_implied=wl.expected,
        launches_in_run=_bodies(window))


def measure(name: str, wl: Workload, device, repeats: int) -> dict:
    """``time_requests``, then the FLOP count and the host's cost of a
    wrapper call."""
    rec = time_requests(name, wl, device, repeats)
    if wl.reset is not None:
        wl.reset()
    t0 = time.perf_counter()
    flops = count_flops(wl.probe) * wl.probe_per_request
    count_s = time.perf_counter() - t0
    if wl.analytic_flops is not None:
        off = flops / wl.analytic_flops - 1
        if abs(off) > TRAIN_FLOPS_RTOL:
            raise AssertionError(
                f"{name}: counted {flops:.4e} FLOPs a request, the analytic "
                f"formula {wl.analytic_flops:.4e} ({off:+.2%}; bound "
                f"{TRAIN_FLOPS_RTOL:.0%})")
    on_card = torch.device(device).type == "cuda"
    peak = H.MFU_PEAKS[wl.precision]
    return dict(
        rec, vs_baseline=rec["value"] / BASELINES[name],
        flops_per_request=flops, flop_count_s=count_s,
        flops_analytic=wl.analytic_flops,
        mfu=flops / (rec["wall_s_median"] * peak) if on_card else None,
        mfu_peak_flops=peak, mfu_peak_of=wl.precision,
        wrapper_host_us=({f"{k} {b}": s * 1e6
                          for (k, b), s in H.wrapper_host_cost().items()}
                         if on_card else None))


def trace(name: str, wl: Workload, rec: dict) -> dict:
    """A warm-up and one request under torch.profiler (one launch window,
    checked): the device time of its kernels and copies."""
    from torch.profiler import ProfilerActivity, profile
    with H.launch_window() as window:
        _timed(wl, "cuda")
        if wl.reset is not None:
            wl.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reply = wl.request()
            torch.cuda.synchronize()
    window.check(f"{name} (traced)", _expected(wl, "cuda", 2), wl.flash_body)
    if reply.checksum != rec["checksum"]:
        raise AssertionError(f"{name}: the traced request's checksum "
                             f"{reply.checksum} differs from the untraced "
                             f"ones' {rec['checksum']}")
    d = H.device_breakdown(prof.key_averages())
    wall_ms = rec["wall_s_median"] * 1e3
    launches = {k: dict(collections.Counter(rec["launches_in_run"][k])
                        + collections.Counter(v))
                for k, v in _bodies(window).items()}
    return dict(launches_in_run=launches,
                device_ms=d["ms"], device_idle_share=1 - d["ms"] / wall_ms,
                k1_device_ms=d["buckets"].get("K1 flash attention", 0.0),
                k2_device_ms=d["buckets"].get("K2 GroupNorm+SiLU", 0.0),
                device_ms_by_bucket=d["buckets"],
                device_top_kernels=[[ms, n, bucket, key[:120]] for
                                    ms, n, bucket, key in d["by_kernel"][:10]],
                device_kernels_per_request=d["kernels"])


DEVICE_FIELDS = ("device_ms", "device_idle_share", "k1_device_ms",
                 "k2_device_ms", "device_ms_by_bucket", "device_top_kernels",
                 "device_kernels_per_request")


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def emit_final(results: dict) -> None:
    """The aggregate, in bench.py's shape: the north-star scenario's rate
    (8 streams, else 1), or the first scenario's under its own name."""
    name = next((n for n in PRIMARY if n in results), None)
    metric = PRIMARY_METRIC
    if name is None:
        name = next(iter(results))
        metric = f"fallback_{name}"
    primary = results[name]
    emit({"metric": metric, "value": primary["value"],
          "unit": primary["unit"], "vs_baseline": primary["vs_baseline"],
          "scenarios": results})


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(names, sizes: Sizes = FULL, device="cuda", repeats: int = REPEATS,
        budget_s: float | None = None, results: dict | None = None) -> list:
    """The scenarios ``names`` in two passes: every untraced timing first,
    then (on the card) one traced request of each. Fills ``results`` (name
    -> record) and prints the records; returns the names that failed or
    were skipped."""
    results = {} if results is None else results
    by_name = dict(SCENARIOS)
    on_card = torch.device(device).type == "cuda"
    card = H.card() if on_card else None
    failed, t0 = [], time.perf_counter()

    def attempt(name, what, fn) -> bool:
        if budget_s is not None and time.perf_counter() - t0 > budget_s:
            emit({"scenario": name, "skipped": f"time budget ({what})"})
            failed.append(name)
            return False
        try:
            fn()
            return True
        except Exception as e:   # one bad scenario must not stop the others
            traceback.print_exc()
            emit({"scenario": name, "error":
                  f"{what}: {type(e).__name__}: {e}"[:500]})
            failed.append(name)
            return False
        finally:
            _free(device)

    for name in names:                     # every untraced timing first
        def untraced():
            t1 = time.perf_counter()
            wl = by_name[name](sizes=sizes, device=device)
            rec = measure(name, wl, device, repeats)
            results[name] = dict(rec, card=card, device=str(device),
                                 **dict.fromkeys(DEVICE_FIELDS),
                                 seconds={"untraced":
                                          time.perf_counter() - t1})
        if attempt(name, "untraced", untraced):
            if not on_card:
                emit({"scenario": name, **results[name]})
            emit_final(results)
    if on_card:
        for name in list(results):         # then one traced request each
            def traced():
                t1 = time.perf_counter()
                wl = by_name[name](sizes=sizes, device=device)
                results[name].update(trace(name, wl, results[name]))
                results[name]["seconds"]["traced"] = time.perf_counter() - t1
            if attempt(name, "traced", traced):
                emit({"scenario": name, **results[name]})
                emit_final(results)
    return failed


def select(wanted) -> list:
    """Scenario names matching any of ``wanted`` (a name or a prefix), in
    SCENARIOS order; all of them when ``wanted`` is empty."""
    names = [n for n, _ in SCENARIOS]
    if not wanted:
        return names
    unknown = [w for w in wanted if not any(n.startswith(w) for n in names)]
    if unknown:
        raise SystemExit(f"bench: no scenario matches {unknown}; the "
                         f"scenarios are {names}")
    return [n for n in names if any(n.startswith(w) for w in wanted)]


def main(argv=None, sizes: Sizes = FULL) -> int:
    strict_f32()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scenario", action="append", default=[],
                        help="run this scenario (a name or a prefix; "
                             "repeatable); default: SDVG_BENCH_SCENARIOS, "
                             "else all ten")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: run on the host (no device metrics)")
    parser.add_argument("--eager", action="store_true",
                        help="run the serving requests eagerly, not as "
                             "compiled programs (utils/jit.disable_jit)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is false; this benchmark "
              "times the port on an NVIDIA GPU (an H100). Pass --device cpu "
              "to run it on the host, where it measures no device.",
              file=sys.stderr)
        return 2
    names = select(args.scenario or list(filter(None, os.environ.get(
        "SDVG_BENCH_SCENARIOS", "").split(","))))
    budget_s = float(os.environ.get("SDVG_BENCH_BUDGET_S", 600))
    hard_s = float(os.environ.get("SDVG_BENCH_HARD_S", 900))
    results = {}

    def watchdog():
        snap = dict(results)
        emit({"watchdog": "fired", "after_s": hard_s})
        if snap:
            emit_final(snap)
        os._exit(1)

    timer = threading.Timer(hard_s, watchdog)
    timer.daemon = True
    timer.start()
    try:
        if args.device == "cuda":
            t0 = time.perf_counter()
            _kernels.build()
            _kernels.library()
            emit({"build": _kernels.BUILD["path"],
                  "nvcc_s": _kernels.BUILD["seconds"],
                  "build_and_load_s": time.perf_counter() - t0})
        with J.disable_jit() if args.eager else contextlib.nullcontext():
            failed = run(names, sizes, args.device, REPEATS, budget_s,
                         results)
    finally:
        timer.cancel()
    if not results:
        print(f"bench: no scenario produced data ({names})", file=sys.stderr)
        return 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
