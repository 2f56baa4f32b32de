"""Prediction entry point (``make_predict_fn`` of
``sd_video_gen_tpu/predict/predict.py``).

frames (B, T, H, W, 3) uint8 -> codec encode + SOS -> rollout with the
optional per-frame refiner -> (context latents, predicted latents). Variants
are arguments:

  mode 'ar'                    autoregressive rollout
  mode 'diff'                  residual rollout: each predicted latent is the
                               model's output plus the last input latent
  mode 'future'/'learned_tgt'  single shot: k frames from one forward
  mode 'text'                  AR rollout conditioned on text embeddings
  rollout 'cached'             the KV-cached frozen-memory path (mode 'ar')
  int8                         int8 products (modes 'ar' / 'diff')

An ``IdentityModel`` in place of the transformer is the copy-last-frame
baseline.

On the card the request (encode, rollout, refiner) runs as one compiled
program per input shape (``utils/jit.py``; the JAX package's
``predict_impl``), and the CLI's decode as another (``decode_impl``). The
request's host-to-device copy stays outside the program: the frames are
copied to the card, then into the program's input. Under ``--mesh`` the
same holds: with a model axis the split UNet's and VAE's collectives and
the sharded attention's routes (batch split, ring, gather) go into the
graphs over the model group, or run eagerly where the backend cannot
capture over it (gloo: ``jit``'s rule); a data rank's refiner noise rows
are part of the request's key (``BatchWindow.key``). The ranks of a model
group hold the same rows of every batch (``Layout.rows``), so they compile
the same keys in the same order.

The CLI (``main``, every flag of the JAX package's plus ``--device``):

  python -m sd_video_gen_tpu_torch.predict.predict --dataset ball \
      --folder <dir> --config <cfg> --pred_frames 4 --save_output True \
      [--codec vae --vae_weights vae.pt] [--denoise True --unet_weights ...]
      [--rollout cached] [--int8 True] [--timing] [--serve SOCK] \
      [--trace_dir DIR] [--device cpu]

reads the model from the port's checkpoint directory
``<checkpoint_dir>/<config>_<index>_<mode>`` (``train/checkpoint.py``), or a
reference ``.pt`` (``--torch_checkpoint``, or one named
``<config>_<index>_<mode>.pt`` in the checkpoint directory), rolls out
batches of ``--batch_clips`` clips and writes ``outputs/<n>/<i>.png`` with a
red border on predicted frames. The loop is pipelined one batch deep: batch
i is decoded and written while batch i + 1 is queued on the device.
``--denoise`` refines every predicted latent at 512px; with it the codec and
the refiner share one VAE at ``--denoise_precision`` (the JAX CLI keeps a
second, f32 copy for the codec). ``--trace_dir DIR`` profiles the whole
run over every thread (a server's spans too) and writes its Chrome trace
under DIR (``utils/profiling.trace``).

Across processes (``--multihost``, or torchrun; one per device), laid out
by ``--mesh data=D,model=M`` (``parallel/mesh.py``; the JAX CLI's
``--mesh``): the transformer is whole on every process and each data rank
rolls out its rows of every batch (``Layout.rows``); with M > 1 and
``--denoise`` the refiner's UNet and VAE (the codec's too: they share it)
are split over the model group by the tensor-parallel rules
(``parallel/sharding.py``). The refiner's noise is drawn for the whole
batch and cut to the rank's rows, so the run refines each clip as one
process would. Rank 0 gathers the decoded clips and alone writes and
prints. ``--serve SOCK`` under ``--mesh`` serves across the group the same
way (``predict/serve.py``): each request's rows are cut as a batch's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from sd_video_gen_tpu_torch.codecs import make_codec
from sd_video_gen_tpu_torch.config import (add_device_flag,
                                           add_multihost_flags,
                                           add_trace_flag, build_arg_parser,
                                           load_config, strict_f32)
from sd_video_gen_tpu_torch.models import build, default_device
from sd_video_gen_tpu_torch.models.identity import IdentityModel
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops.cached_rollout import (cached_rollout,
                                                       quantize_rollout_params)
from sd_video_gen_tpu_torch.ops.quantized import (quantize_frame_transformer,
                                                  quantized_ar_apply)
from sd_video_gen_tpu_torch.ops.rollout import ar_rollout
from sd_video_gen_tpu_torch.parallel import multihost
from sd_video_gen_tpu_torch.parallel.mesh import make_layout
from sd_video_gen_tpu_torch.utils import profiling
from sd_video_gen_tpu_torch.utils.jit import jit


def make_predict_fn(model: torch.nn.Module, codec, pred_frames: int,
                    window: int, mode: str = "ar",
                    refiner: Optional[Callable] = None,
                    rollout: str = "full", int8: bool = False,
                    future_horizon: Optional[int] = None,
                    rows=None, groups=()):
    """``predict(frames_u8, text_embeds=None) -> (context_latents (B, T, L),
    preds (B, P, L))``.

    The request after its host-to-device copy is one ``jit`` program
    (``predict.impl``): a CUDA graph per frames shape on the card, the
    function as it is on the CPU. ``rows``: the ``BatchWindow``
    the refiner's noise is cut to, whose ``key()`` joins the program's key;
    ``groups``: the process groups the refiner's collectives run over.

    ``codec`` is a ``PixelCodec`` or ``VAECodec``; ``refiner`` the hook from
    ``diffusion/refine.make_denoise_refiner``. ``mode='text'`` takes text
    embeddings (B, text_embed_dim) as the second argument. With ``int8`` the
    model's Linear weights are quantised here, once.

    ``rollout='cached'`` (mode 'ar' only): frame 1 is the full re-forward's,
    later frames condition on the frozen context memory instead of
    re-encoding predictions.
    """
    if rollout == "cached" and mode != "ar":
        raise ValueError("--rollout cached supports --train_mode ar only")
    if mode in ("future", "learned_tgt") and future_horizon is not None \
            and pred_frames > future_horizon:
        raise ValueError(
            f"pred_frames {pred_frames} exceeds the model's trained future "
            f"horizon {future_horizon} (frames_to_predict)")
    if int8 and mode not in ("ar", "diff"):
        raise ValueError("--int8 supports --train_mode ar/diff only")

    apply_fn = model
    cached_params = model
    if int8 and rollout == "cached":
        cached_params = quantize_rollout_params(model)
    elif int8:
        qp = quantize_frame_transformer(model)
        H, pe = model.cfg.num_heads, model.cfg.pe_mode

        def apply_fn(src, tgt, tgt_mask=None, **kw):
            return quantized_ar_apply(qp, src, tgt, tgt_mask=tgt_mask,
                                      num_heads=H, pe_mode=pe)
    if mode == "diff":
        base_apply = apply_fn

        def apply_fn(src, tgt, tgt_mask=None, **kw):
            out = base_apply(src, tgt, tgt_mask=tgt_mask, **kw)
            # residual: next latent = model output + last input frame
            return torch.cat([out[:, :-1],
                              (out[:, -1] + tgt[:, -1])[:, None]], dim=1)

    def predict_impl(frames, text_embeds, window_key=None):
        # window_key only keys the program: the refiner reads the window
        profiling.mark("vae", frames.device)
        latents = codec.encode_batch(frames, use_sos=True)
        kwargs = {"text_embeds": text_embeds} if text_embeds is not None \
            else {}
        if mode in ("future", "learned_tgt"):
            # single shot: the model's last ``frames_to_predict`` outputs are
            # future frames 1..k, so fewer than k means the FIRST pred_frames
            # of that span; learned_tgt ignores tgt and decodes its queries
            y_in = latents[:, 1:]                   # drop SOS
            profiling.mark("rollout", y_in.device)
            out = model(y_in, y_in, tgt_mask=None, **kwargs)
            k = future_horizon or pred_frames
            preds = out[:, -k:][:, :pred_frames]
            if refiner is not None:
                preds = torch.stack([refiner(preds[:, i], i)
                                     for i in range(preds.shape[1])], dim=1)
        elif rollout == "cached":
            preds = cached_rollout(model.cfg, cached_params, latents,
                                   pred_frames, refine_fn=refiner)
        else:
            preds = ar_rollout(apply_fn, latents, pred_frames, window=window,
                               refine_fn=refiner, model_kwargs=kwargs)
        profiling.mark("end", preds.device)
        return latents[:, 1:], preds

    impl = jit(predict_impl, name="predict_impl", groups=groups)

    @torch.inference_mode()
    def predict(frames_u8, text_embeds=None):
        frames = (frames_u8 if isinstance(frames_u8, torch.Tensor) else
                  torch.from_numpy(np.array(frames_u8, np.uint8)))
        # the host-to-device copy, outside the compiled program
        with profiling.span("predict.h2d"):
            frames = frames.to(codec.device)
        return impl(frames, text_embeds, None if rows is None else rows.key())

    predict.impl = impl
    return predict


def make_decode_fn(codec, groups=()):
    """``codec.decode_latents`` as one compiled program per shape (the JAX
    CLI's ``decode_impl``: an eager VAE decode launches hundreds of kernels
    a batch); ``groups``: those a split VAE's collectives run over. Its
    stage marks (``utils/profiling.mark``): ``vae``, ``end``."""
    def decode_impl(latents):
        profiling.mark("vae", latents.device)
        out = codec.decode_latents(latents)
        profiling.mark("end", out.device)
        return out

    return jit(decode_impl, name="decode_impl", groups=groups)


def load_model_params(cfg, args, model: torch.nn.Module,
                      mode_flag: str = "") -> torch.nn.Module:
    """Fill ``model`` from ``<checkpoint_dir>/<config>_<index>_<mode>``: a
    reference ``.pt`` given by ``--torch_checkpoint`` or sitting there under
    that name plus ``.pt``, else the port's checkpoint directory of that
    name (only its parameters are read). Either way every parameter must be
    filled and every saved tensor used, with equal shapes."""
    from sd_video_gen_tpu_torch.diffusion.weights import load_weights
    from sd_video_gen_tpu_torch.train import checkpoint as ckpt
    path = ckpt.checkpoint_path(args.checkpoint_dir, args.config, args.index,
                                mode_flag or args.mode or "test")
    torch_path = getattr(args, "torch_checkpoint", None)
    if torch_path is None and os.path.isfile(path + ".pt"):
        torch_path = path + ".pt"
    if torch_path is not None:
        return load_weights(model, "transformer", torch_path)
    with torch.no_grad():
        model.load_state_dict(ckpt.restore_params(path, model), strict=True)
    return model


def sd_modules(args, device, dtype, shard=None):
    """The SD VAE, UNet and CLIP text encoder at SD-v1.4 widths from
    ``--vae_weights`` / ``--unet_weights`` / ``--clip_weights`` (seeded
    random weights where a file is not given), on ``device`` in ``dtype``;
    with ``shard`` the VAE and UNet are that model rank's slices."""
    from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
    from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextEncoder)
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    return (build_from_file(AutoencoderKL, VAEConfig(), "vae",
                            args.vae_weights, device, dtype, seed=0,
                            shard=shard),
            build_from_file(UNet2DCondition, UNetConfig(), "unet",
                            args.unet_weights, device, dtype, seed=1,
                            shard=shard),
            build_from_file(CLIPTextEncoder, CLIPTextConfig(), "clip",
                            args.clip_weights, device, dtype, seed=2))


def build_refiner(args, cfg, device, layout, window, hi_res):
    """The ``--denoise`` refiner at ``hi_res`` (None: the native latent
    grid) and its VAE, at ``--denoise_precision``; the UNet and VAE split
    over ``layout``'s model group, and the noise cut to ``window``'s rows
    of each batch where the layout has a data axis."""
    from sd_video_gen_tpu_torch.diffusion.refine import (default_noise,
                                                         make_denoise_refiner,
                                                         windowed_noise)
    from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
    vae, unet, clip = sd_modules(
        args, device, torch.bfloat16 if args.denoise_precision == "bf16"
        else torch.float32, layout.shard)
    noise = None
    if layout.data > 1:
        noise = windowed_noise(default_noise(args.denoise_start_step, device),
                               window)
    refine = make_denoise_refiner(
        SDPipeline(vae, unet, clip, tokenizer_dir=args.tokenizer_dir),
        cfg.frame_size, args.denoise_start_step, hi_res=hi_res,
        noise_fn=noise, sampler=args.denoise_sampler,
        solver_steps=args.denoise_solver_steps)
    return refine, vae


def build_codec(cfg, args, device, vae=None):
    """The ``--codec`` codec; ``vae`` (the refiner's, shared) or one from
    ``--vae_weights`` in f32 (seeded random weights without a file)."""
    if args.codec == "vae" and vae is None:
        from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
        from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
        vae = build_from_file(AutoencoderKL, VAEConfig(), "vae",
                              args.vae_weights, device, seed=0)
    return make_codec(cfg, args.codec, vae=vae, device=device)


def build_model(cfg, args, device) -> torch.nn.Module:
    """``IdentityModel`` under ``--naive``, else the FrameTransformer of
    ``--train_mode`` (``diff`` serves an 'ar' model) filled by
    ``load_model_params``."""
    if args.naive:
        return IdentityModel()
    mc = FrameTransformerConfig.from_config(
        cfg, mode="ar" if args.train_mode == "diff" else args.train_mode,
        pe_mode="reference_batch" if args.reference_pe else "timestep")
    model = build(FrameTransformer, mc, device)
    return load_model_params(cfg, args, model, args.mode or "test")


def build_embedder(args, device):
    if args.train_mode != "text":
        return None
    from sd_video_gen_tpu_torch.models.text_embed import ClassNameEmbedder
    return (ClassNameEmbedder.from_npy(args.text_table, device=device)
            if args.text_table else ClassNameEmbedder(101, 384,
                                                      device=device))


def save_frames(imgs: np.ndarray, is_pred: list[bool],
                out_root: str = "outputs") -> str:
    """Write one clip's frames as ``<out_root>/<n>/<i>.png`` under the first
    free integer ``n`` (a count of entries would collide after deletions and
    overwrite an earlier run), predicted frames with a red border."""
    import cv2
    os.makedirs(out_root, exist_ok=True)
    n = len(os.listdir(out_root))
    while os.path.exists(os.path.join(out_root, str(n))):
        n += 1
    folder = os.path.join(out_root, str(n))
    os.makedirs(folder)
    for i, img in enumerate(imgs):
        if is_pred[i]:
            img = cv2.copyMakeBorder(img, 1, 1, 1, 1, cv2.BORDER_CONSTANT,
                                     value=[0, 0, 255])
        cv2.imwrite(os.path.join(folder, f"{i}.png"), img)
    return folder


def show_frames(imgs: np.ndarray, is_pred: list[bool], fullscreen: bool):
    import cv2
    for i, img in enumerate(imgs):
        if is_pred[i]:
            img = cv2.copyMakeBorder(img, 1, 1, 1, 1, cv2.BORDER_CONSTANT,
                                     value=[0, 0, 255])
        if fullscreen:
            cv2.namedWindow("frame", cv2.WND_PROP_FULLSCREEN)
            cv2.setWindowProperty("frame", cv2.WND_PROP_FULLSCREEN,
                                  cv2.WINDOW_FULLSCREEN)
        cv2.imshow("frame", img)
        cv2.waitKey(0)


def add_serving_flags(parser):
    """The flags the predict and predict-FVD CLIs share beyond the config's."""
    parser.add_argument("--train_mode", type=str, default="ar",
                        choices=["ar", "future", "diff", "text",
                                 "learned_tgt"])
    parser.add_argument("--naive", type=lambda s: s.lower() == "true",
                        default=False, help="Identity copy-last-frame baseline")
    parser.add_argument("--reference_pe", action="store_true",
                        help="serve with the reference's per-batch-index "
                             "positional encoding, so converted reference "
                             "checkpoints reproduce their trained forward")
    parser.add_argument("--text_table", type=str, default=None,
                        help="npy table of class embeddings for text mode; "
                             "default is the hash-seeded fallback table")
    parser.add_argument("--denoise_sampler", type=str, default="ddim",
                        choices=["ddim", "dpmpp"],
                        help="ddim = reference-parity tail; dpmpp = "
                             "DPM-Solver++(2M) over the same noise interval "
                             "in about half the UNet evaluations")
    parser.add_argument("--denoise_solver_steps", type=int, default=None,
                        help="dpmpp UNet evaluations (default: half the "
                             "DDIM tail, at least 2)")
    return add_device_flag(add_multihost_flags(parser))


def build_predict_parser():
    parser = add_serving_flags(build_arg_parser())
    parser.add_argument("--codec", type=str, default="pixel",
                        choices=["pixel", "vae"])
    parser.add_argument("--max_clips", type=int, default=4)
    parser.add_argument("--batch_clips", type=int, default=1,
                        help="clips rolled out per call (serving batch)")
    parser.add_argument("--rollout", type=str, default="full",
                        choices=["full", "cached"],
                        help="cached: KV-cached frozen-memory serving path "
                             "(ar mode)")
    parser.add_argument("--int8", type=lambda s: s.lower() == "true",
                        default=False,
                        help="int8-quantise the transformer's weights for "
                             "serving (full or cached rollout; ar/diff)")
    parser.add_argument("--timing", action="store_true",
                        help="print a per-stage wall-clock JSON line at exit")
    parser.add_argument("--serve", type=str, default=None, metavar="SOCK",
                        help="persistent serving: warm up once, print "
                             "SERVE_READY and answer clip batches on this "
                             "Unix socket until shutdown (predict/serve.py)")
    return add_trace_flag(parser)


def join_run(parser, args):
    """Join the process group where asked (``--multihost``) and lay it out
    by ``--mesh`` (``parallel/mesh.make_layout``): the layout; one process
    on its own without either. Refuses what the layout cannot serve."""
    if args.multihost:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, args.device)
    layout = make_layout(args.mesh)
    if layout.data > 1 and args.reference_pe:
        # its positional term is the clip's index in the global batch
        parser.error("--reference_pe adds PE(batch index): a data axis "
                     "above 1 would index each rank's rows from 0")
    return layout


@multihost.releases_programs
def main(argv=None):
    strict_f32()
    parser = build_predict_parser()
    args = parser.parse_args(argv)
    if args.reference_pe and (args.int8 or args.rollout == "cached"):
        parser.error("--reference_pe is the full-forward compat path "
                     "(incompatible with --int8 / --rollout cached)")
    if args.rollout == "cached" and args.naive:
        parser.error("--rollout cached needs the transformer model "
                     "(incompatible with --naive)")
    if args.int8 and args.train_mode not in ("ar", "diff"):
        parser.error("--int8 supports --train_mode ar/diff only")
    if args.int8 and args.naive:
        parser.error("--int8 quantizes the transformer "
                     "(incompatible with --naive)")
    layout = join_run(parser, args)
    with profiling.trace(args.trace_dir):
        _predict(args, layout)


def _predict(args, layout):
    """``main`` once the flags are read and the group joined."""
    cfg = load_config(args.config, args.config_dir)
    device = multihost.rank_device(default_device(args.device))
    lead = multihost.is_coordinator()

    from sd_video_gen_tpu_torch.diffusion.refine import BatchWindow
    window = BatchWindow()
    refine_fn, vae = None, None
    if args.denoise:
        refine_fn, vae = build_refiner(args, cfg, device, layout, window,
                                       hi_res=512)
    codec = build_codec(cfg, args, device, vae)
    model = build_model(cfg, args, device)
    # --naive is the pure copy-last-frame control: never wrap Identity with
    # the diff residual add (see evaluation/predict_fvd.py)
    naive_mode = "ar" if (args.naive and args.train_mode == "diff") \
        else args.train_mode
    # compiled, the split modules' collectives over the model group inside
    # the graphs (module docstring)
    groups = (layout.model_group,) if args.denoise else ()
    predict = make_predict_fn(model, codec, args.pred_frames,
                              window=cfg.frames_per_clip, mode=naive_mode,
                              refiner=refine_fn, rollout=args.rollout,
                              int8=args.int8 and not args.naive,
                              future_horizon=cfg.frames_to_predict,
                              rows=window, groups=groups)
    decode = make_decode_fn(codec, groups=groups)
    embedder = build_embedder(args, device)

    if args.serve:
        from sd_video_gen_tpu_torch.predict.serve import serve
        # across a group every rank serves its rows; rank 0 answers
        serve(args.serve, predict, decode,
              batch_clips=args.batch_clips,
              frames_per_clip=cfg.frames_per_clip,
              frame_size=cfg.frame_size, embedder=embedder,
              layout=layout, window=window)
        return

    from sd_video_gen_tpu_torch.train.trainer import build_dataset
    # single-shot modes feed only the context: build_dataset's training
    # extension would hand the model the very frames it is to predict
    exact = (cfg.frames_per_clip
             if args.train_mode in ("future", "learned_tgt") else None)
    dataset = build_dataset(cfg, args,
                            "test" if args.mode != "train" else "train",
                            exact_frames=exact)
    n_clips = min(len(dataset), args.max_clips)
    n_done = n_batches = 0
    gathers = layout.data * layout.model > 1
    stage_s = {"data": 0.0, "dispatch": 0.0, "decode": 0.0, "io": 0.0}
    # The warm window starts when the first batch's rollout has ended: on
    # the CPU a call returns then; on the card the host runs ahead of the
    # device (its clock would start the window after batch 2 is enqueued),
    # so a CUDA event after the first enqueue marks it.
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if device.type == "cuda" else None)
    first_sync_s = None
    t_start = time.perf_counter()
    if events:
        events[0].record()

    @torch.inference_mode()
    def process(pending):
        """Decode, fetch and write one completed batch (host side)."""
        nonlocal n_done
        context, preds, n_items = pending
        t2 = time.perf_counter()
        imgs = None
        if context is not None:
            # the reference's layout: the context minus its last frame,
            # then the predictions
            seq = torch.cat([context[:, :-1], preds], dim=1)
            is_pred = ([False] * (context.shape[1] - 1)
                       + [True] * preds.shape[1])
            T_out = seq.shape[1]
            imgs = decode(seq.reshape(-1, seq.shape[-1])).cpu().numpy()
        if gathers:
            # every data rank's rows, in order, from model rank 0 of each
            parts = multihost.gather_to_coordinator(
                imgs if layout.model_rank == 0 else None)
            if lead:
                imgs = np.concatenate([
                    parts[d * layout.model] for d in range(layout.data)
                    if parts[d * layout.model] is not None])
        t3 = time.perf_counter()
        for b in range(n_items if lead else 0):
            clip_imgs = imgs[b * T_out:(b + 1) * T_out]
            if args.save_output:
                print("saved to:", save_frames(clip_imgs, is_pred))
            if args.show:
                show_frames(clip_imgs, is_pred, args.fullscreen)
            n_done += 1
        stage_s["decode"] += t3 - t2
        stage_s["io"] += time.perf_counter() - t3

    # one batch deep: batch i's decode and writes run while batch i + 1's
    # rollout is queued on the device
    pending = None
    for start in range(0, n_clips, args.batch_clips):
        n_batches += 1
        t0 = time.perf_counter()
        n = min(args.batch_clips, n_clips - start)
        lo, hi = layout.rows(n)            # this data rank's rows
        window.set(lo, hi, n)
        items = [dataset[i] for i in range(start + lo, start + hi)]
        text_embeds = None
        if items and embedder is not None:
            text_embeds = embedder(
                [int(it[0][0]) if isinstance(it[0], (list, tuple)) else 0
                 for it in items])
        t1 = time.perf_counter()
        context = preds = None
        if items:     # a data rank may hold no row of a short batch
            context, preds = predict(
                torch.from_numpy(np.stack([it[1] for it in items])),
                text_embeds)
        stage_s["data"] += t1 - t0
        stage_s["dispatch"] += time.perf_counter() - t1
        if n_batches == 1:
            if events:
                events[1].record()
            else:
                first_sync_s = time.perf_counter() - t_start
        if pending is not None:
            process(pending)
        pending = (context, preds, n)
    if pending is not None:
        process(pending)      # its fetch waited for every batch's work
        if events:
            first_sync_s = events[0].elapsed_time(events[1]) / 1e3
    if not lead:
        return
    print(f"predicted {args.pred_frames} frames for {n_done} clips")
    if args.timing:
        print(json.dumps({
            "stage_s": {k: round(v, 3) for k, v in stage_s.items()},
            "total_s": round(time.perf_counter() - t_start, 3),
            "clips": n_done, "pred_frames_per_clip": args.pred_frames,
            "batches": n_batches,
            # the warm rate: (clips - batch_1) * pred_frames /
            # (total - first_sync)
            "first_sync_s": (round(first_sync_s, 3)
                             if first_sync_s is not None else None),
            "note": "first_sync_s: the first batch's rollout ended (on the "
                    "card, by a CUDA event); dispatch queues the rollout on "
                    "the device, its time shows inside decode (pipelined "
                    "loop)"}))


if __name__ == "__main__":
    main()
