"""Rollout + FVD evaluation CLI (``sd_video_gen_tpu/evaluation/predict_fvd.py``).

  python -m sd_video_gen_tpu_torch.evaluation.predict_fvd --dataset mnist \
      --folder mnist_test_seq.npy --config <cfg> --pred_frames 4 \
      [--codec vae --denoise True --vae_weights ... --unet_weights ...] \
      [--i3d_weights i3d.pt] [--fvd_api batch] [--naive True] [--timing] \
      [--device cpu]

One script with flags, as in the JAX package:
  --fvd_api streaming : FeatureStats accumulators, population covariances
  --fvd_api batch     : every clip's logits, Bessel covariances
  --naive             : the copy-last-frame control
  --denoise           : per-frame partial denoise on the native latent grid
                        from DDIM step 48 (the evaluation harness's variant)
  --train_mode text   : a text-conditioned model

Per batch the ground-truth clips (context + pred_frames long) stream through
I3D into the real statistics; the rollouts of the same contexts, decoded to
pixels, into the generated ones. FVD prints every --fvd_every batches and at
the end, with the pixel MSE of the predicted frames. I3D runs in full f32
(``models/i3d.py``). With ``--denoise`` the codec shares the refiner's VAE at
``--denoise_precision``. ``--timing`` prints, per batch, the rollout and I3D
walls with the device synchronised at their ends (on the card, with the
spans between CUDA events around each).

The JAX CLI's three jitted programs are compiled (``utils/jit.py``: one
CUDA graph per batch shape on the card, the ragged last batch another):
the predictor (``predict_impl``), the decode (``decode_impl``) and I3D
(``features``, ``fvd.jitted_features``); the statistics merge on the host
in f64 after each replay.

Across processes (``--multihost``, or torchrun; one per device), laid out
by ``--mesh`` (``parallel/mesh.py``; the streaming API only, as in the JAX
CLI): each data rank rolls out and runs I3D on its slice of every batch,
and the ``FeatureStats`` sums and the MSE sums are summed over the ``data``
group (``make_sharded_features``, the JAX package's shard_map + psum); a
ragged tail batch is trimmed to a multiple of the data axis. The refiner's
noise is drawn for the whole batch and cut to the rank's rows, as in the
predict CLI (the rows join the predictor's key); the refiner is not split
over a model axis (nor is it in the JAX CLI). So no collective runs inside
a program: each rank compiles its own, and the f64 sums meet on the host
after I3D's replay, as the JAX package's ``psum`` ends its ``shard_map``.
Rank 0 alone prints.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings

import numpy as np
import torch

from sd_video_gen_tpu_torch.config import (build_arg_parser, load_config,
                                           strict_f32)
from sd_video_gen_tpu_torch.evaluation.fvd import (FeatureStats, compute_fvd,
                                                   frechet_distance,
                                                   jitted_features)
from sd_video_gen_tpu_torch.models import default_device
from sd_video_gen_tpu_torch.models.i3d import (I3DConfig, InceptionI3d,
                                               convert_i3d)
from sd_video_gen_tpu_torch.parallel import multihost

I3D_SEED = 0


def load_i3d(weights_path: str | None, device=None) -> InceptionI3d:
    """The Kinetics-400 I3D in f32 on ``device`` (the card by default),
    frozen: from a ``pytorch_i3d``-layout ``.pt``, or, without one, seeded
    random weights with a warning. Those are drawn on the host from a
    ``torch.Generator`` seeded ``I3D_SEED``, so every device gets the same
    numbers: BatchNorm variances and scales are ones, everything else
    N(0, 0.05^2), as the JAX package's ``load_i3d(None)`` draws them (its
    draws themselves cannot be reproduced)."""
    device = default_device(device)
    with torch.device("meta"):
        i3d = InceptionI3d(I3DConfig())
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    else:
        warnings.warn("no I3D weights — random init; FVD values are only "
                      "self-consistent, not comparable to published numbers",
                      stacklevel=2)
        g = torch.Generator().manual_seed(I3D_SEED)
        sd = {}
        for k, v in i3d.state_dict().items():
            if k.endswith("num_batches_tracked"):
                sd[k] = torch.zeros((), dtype=torch.long)
            elif k.endswith(("bn.running_var", "bn.weight")):
                sd[k] = torch.ones(v.shape)
            else:
                sd[k] = torch.randn(v.shape, generator=g) * 0.05
    i3d = i3d.to_empty(device=device)
    convert_i3d(i3d, {k: v.to(device, torch.float32) if v.is_floating_point()
                      else v.to(device) for k, v in sd.items()})
    return i3d.eval().requires_grad_(False)


def make_sharded_features(features, layout):
    """Data-parallel I3D features: ``fn(videos_u8)`` -> the ``FeatureStats``
    of the whole global batch, from this data rank's slice of it
    (``videos_u8``, (b, T, H, W, 3) uint8): ``features`` (the I3D forward
    on uint8 clips, compiled or not) on the slice, its (n, sum, sum of
    outer products) in f64 summed over ``layout``'s data group, so every
    rank holds the global statistics (the JAX package's shard_map + psum
    over ``data``)."""
    def features_stats(videos_u8):
        st = FeatureStats(400).append(features(videos_u8))
        if layout.data == 1:
            return st
        device = videos_u8.device
        parts = [torch.as_tensor(np.asarray(a, np.float64), device=device)
                 for a in (st.n, st.raw_sum, st.raw_prod)]
        multihost.all_reduce_sum(parts, "fvd_stats", layout.data_group)
        n, raw_sum, raw_prod = (p.cpu().numpy() for p in parts)
        return FeatureStats(st.dim, np.float64(n), raw_sum, raw_prod)
    return features_stats


def build_parser():
    from sd_video_gen_tpu_torch.predict.predict import add_serving_flags
    parser = add_serving_flags(build_arg_parser())
    parser.add_argument("--codec", type=str, default="pixel")
    parser.add_argument("--max_clips", type=int, default=64)
    parser.add_argument("--batch_clips", type=int, default=8)
    parser.add_argument("--fvd_api", type=str, default="streaming",
                        choices=["streaming", "batch"])
    parser.add_argument("--fvd_every", type=int, default=8)
    parser.add_argument("--i3d_weights", type=str, default=None)
    parser.add_argument("--timing", action="store_true",
                        help="print per-batch rollout and I3D walls (device "
                             "synchronised) as a JSON line at the end")
    # the reference eval harness runs start_step=48 (2 refine steps of 50):
    # the predict CLI's default 40 would over-denoise the evaluation
    parser.set_defaults(denoise_start_step=48)
    return parser


@torch.inference_mode()
@multihost.releases_programs
def main(argv=None):
    strict_f32()
    from sd_video_gen_tpu_torch.data import BatchLoader
    from sd_video_gen_tpu_torch.diffusion.refine import BatchWindow
    from sd_video_gen_tpu_torch.predict.predict import (build_codec,
                                                        build_embedder,
                                                        build_model,
                                                        build_refiner,
                                                        join_run,
                                                        make_decode_fn,
                                                        make_predict_fn)
    from sd_video_gen_tpu_torch.train.trainer import build_dataset
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh and args.fvd_api != "streaming":
        parser.error("--mesh implies --fvd_api streaming (FeatureStats "
                     "summed over the data axis)")
    if args.pred_frames <= 1:
        args.pred_frames = 4
    cfg = load_config(args.config, args.config_dir)
    # I3D's temporal stack needs >= 9 frames end to end
    total = cfg.frames_per_clip + args.pred_frames
    if total < 9:
        parser.error(
            f"frames_per_clip ({cfg.frames_per_clip}) + pred_frames "
            f"({args.pred_frames}) = {total} < 9, the I3D temporal minimum "
            "— raise --pred_frames or use a config with longer clips")
    layout = join_run(parser, args)
    # the JAX CLI shards only the batch: the refiner stays whole
    layout = dataclasses.replace(layout, model=1, model_rank=0,
                                 model_group=None)
    device = multihost.rank_device(default_device(args.device))
    lead = multihost.is_coordinator()
    window = BatchWindow()

    refiner, vae = None, None
    if args.denoise:
        # native-resolution partial denoise, the evaluation harness's
        # variant (start step 48, no 512px upscale)
        refiner, vae = build_refiner(args, cfg, device, layout, window,
                                     hi_res=None)
    codec = build_codec(cfg, args, device, vae)
    model = build_model(cfg, args, device)
    i3d = load_i3d(args.i3d_weights, device)
    # --naive is the reference's pure copy-last-frame control: the diff
    # mode's residual add must not wrap it (Identity + last latent doubles
    # the latent and scores another baseline)
    naive_mode = "ar" if (args.naive and args.train_mode == "diff") \
        else args.train_mode
    predict = make_predict_fn(model, codec, args.pred_frames,
                              window=cfg.frames_per_clip, mode=naive_mode,
                              refiner=refiner,
                              future_horizon=cfg.frames_to_predict,
                              rows=window)
    decode = make_decode_fn(codec)
    embedder = build_embedder(args, device)
    features = jitted_features(i3d)
    stats = make_sharded_features(features, layout)

    def gen_video(context_frames, indices):
        """context uint8 -> [context + decoded predictions] uint8 video."""
        text_embeds = None
        if embedder is not None:
            text_embeds = embedder(
                [int(i[0]) if isinstance(i, (list, tuple)) else 0
                 for i in indices])
        _, preds = predict(context_frames, text_embeds)
        B, P, L = preds.shape
        dec = decode(preds.reshape(B * P, L))
        return torch.cat([context_frames,
                          dec.reshape(B, P, *dec.shape[1:])], dim=1)

    # the clip length is pinned to context + horizon: build_dataset's
    # mode-based extensions must not stack on top of it
    dataset = build_dataset(cfg, args, "test" if args.mode != "train"
                            else "train",
                            exact_frames=cfg.frames_per_clip
                            + args.pred_frames)
    loader = BatchLoader(dataset, args.batch_clips, epoch_ratio=1.0,
                         shuffle=False, drop_last=False)

    st_real, st_gen = FeatureStats(400), FeatureStats(400)
    logits_real, logits_gen = [], []
    n_clips = 0
    mse_sum, mse_n = 0.0, 0   # pixel MSE in [0, 1] over the predicted frames
    walls = []
    F = cfg.frames_per_clip
    t_start = time.perf_counter()
    for bi, (indices, frames) in enumerate(loader):
        if n_clips >= args.max_clips:
            break
        n = len(frames)
        if n % layout.data:
            # ragged tail under a data axis: trim to a shardable size
            # instead of failing after most clips were processed
            keep = (n // layout.data) * layout.data
            if lead:
                print(f"[mesh] trimming ragged tail batch {n} -> {keep} "
                      f"(data axis {layout.data})")
            if keep == 0:
                continue
            n = keep
        lo, hi = layout.rows(n)            # this data rank's rows
        window.set(lo, hi, n)
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  if args.timing and device.type == "cuda" else [])
        if events:
            events[0].record()
        t0 = time.perf_counter()
        frames = torch.from_numpy(np.asarray(frames[lo:hi])).to(device)
        gen = gen_video(frames[:, :F], list(indices)[lo:hi])
        diff = (gen[:, F:].float() - frames[:, F:].float()) / 255.0
        mse_sum += float(torch.sum(diff * diff))
        mse_n += diff.numel()
        t1 = time.perf_counter()
        if events:
            events[1].record()
        if args.fvd_api == "streaming":
            st_real = st_real.merge(stats(frames))
            st_gen = st_gen.merge(stats(gen))
        else:
            logits_real.append(features(frames).cpu().numpy())
            logits_gen.append(features(gen).cpu().numpy())
        t2 = time.perf_counter()
        walls.append({"clips": int(frames.shape[0]),
                      "gen_s": round(t1 - t0, 4), "i3d_s": round(t2 - t1, 4)})
        if events:
            events[2].record()
            events[2].synchronize()
            walls[-1].update(
                gen_span_ms=round(events[0].elapsed_time(events[1]), 3),
                i3d_span_ms=round(events[1].elapsed_time(events[2]), 3))
        n_clips += n
        if (bi + 1) % args.fvd_every == 0 and lead:
            print(f"[{n_clips} clips] FVD so far: "
                  f"{_fvd(args, st_real, st_gen, logits_real, logits_gen):.3f}")

    fvd = _fvd(args, st_real, st_gen, logits_real, logits_gen)
    if layout.data > 1:
        sums = torch.tensor([mse_sum, mse_n], dtype=torch.float64,
                            device=device)
        multihost.all_reduce_sum([sums], "mse", layout.data_group)
        mse_sum, mse_n = sums.tolist()
    mse = mse_sum / max(mse_n, 1)
    if not lead:
        return fvd, mse
    print(f"FVD ({args.fvd_api}, {n_clips} clips): {fvd:.3f}  "
          f"pred MSE: {mse:.5f}")
    if args.timing:
        print(json.dumps({"batches": walls,
                          "total_s": round(time.perf_counter() - t_start, 3),
                          "note": "gen_s: rollout, decode and MSE (ends on "
                                  "a device sync); i3d_s: I3D of the real "
                                  "and the generated clips; *_span_ms: the "
                                  "card's time between CUDA events around "
                                  "each part, idle gaps included"}))
    return fvd, mse


def _fvd(args, st_real, st_gen, logits_real, logits_gen):
    if args.fvd_api == "streaming":
        return compute_fvd(st_real, st_gen)
    return frechet_distance(np.concatenate(logits_real),
                            np.concatenate(logits_gen))


if __name__ == "__main__":
    main()
