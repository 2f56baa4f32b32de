"""One Trainer with strategy flags (``sd_video_gen_tpu/train/trainer.py``).

Strategy modes (``--train_mode``):
  - 'ar'     : teacher-forced next-frame AR: src = [SOS + frames],
               tgt = seq[:-1], target = seq[1:], causal mask, loss on the
               last ``frames_to_predict`` positions.
  - 'future' : k-step single-shot: no SOS, y_input = seq[:, :-k],
               target = seq[:, -k:], no mask.
  - 'diff'   : residual prediction: the model's output for the last k
               positions is added to the previous-frame latents before the
               loss.
  - 'text'   : class-name conditioning: per-batch class-id -> text-embedding
               lookup, on the device.
  - 'learned_tgt': DETR-style learned decoder queries; trains with the
               'future' split.

The step, as in the JAX package: frames cross host -> device once per step
as uint8; normalise, latent encode (the codec is frozen and runs under
``torch.no_grad()``: the gradient is taken with respect to the transformer's
parameters only), forward, loss in f32, backward and the Adam update
(``train/optim.py``) all run on the device. Loss components stay on the
device and are summed there; the loop fetches them once per epoch, so no
step synchronises the host. The dropout draws of a step come from a
``torch.Generator`` seeded from (seed, step number): a run resumed from a
checkpoint draws what an uninterrupted one would.

Compiled programs (``utils/jit.py``, the JAX trainer's ``jax.jit`` sites):
the step after its host part (``step_impl``, its state donated: the
parameters and Adam's moments update in place inside the program), the
eval step (``eval_impl``) and in-training FVD's batch (``fvd_batch``) each
run as one CUDA graph per batch shape on the card, and as they are on the
CPU. The host part of a step seeds the dropout generators (registered with
the capture, so a replay draws what the eager step draws for that seed),
puts the batch on the device, fills Adam's bias corrections for the step
number and advances it: nothing in the program changes from step to step
but what those set. Over a process group the collectives go into the
graphs: the gradient all-reduce over the ``data`` group, and the model
axis's all-reduces in the forward and the backward. Whether they can is
the backend's rule (``jit.compilable``: NCCL yes, gloo no), which each
``jit`` applies to the groups it was given: over gloo the programs run
eagerly. Gathers, checkpoints, barriers and the epoch's metric reductions
stay outside the graphs.

Precisions (``--precision``): ``f32``; ``bf16`` (bf16 compute on f32 master
parameters with f32 moments); ``bf16_full`` (bf16 parameters and bf16 Adam
moments).

In-training FVD (``--fvd_every``, ``Trainer.fvd_validation``): every few
epochs teacher-forced predictions are decoded to pixels and streamed with
the ground truth through I3D (``evaluation/fvd.py``), per-batch sums on the
device, the merge on the host in f64. ``--vae_weights`` loads the VAE codec
from a weight file (``diffusion/weights.py``).

Input: the frame datasets, UCF-101 (``--dataset ucf*``,
``data/ucf101.py``) or a pre-built frame cache read by the C++ loader
(``--native_cache``, ``data/native_loader.py``).

Across processes (``--multihost``, or torchrun), one device each, laid
out by ``--mesh data=D,model=M`` (``parallel/mesh.py``; default: every
process on ``data``). Data parallel: every data rank loads its slice of
each global batch, runs the step on its own device, and the gradients are
averaged over the ``data`` group after the backward pass (with equal
slices, the global batch's mean gradient); the epoch's loss sums are
averaged the same way. Tensor parallel (M > 1): the ranks of a model group
share one slice of every batch and each holds its shard of the
FrameTransformer (``parallel/sharding.py``: the attention heads and the
feed-forward's hidden features) and of Adam's moments; the model group's
collectives are the autograd functions of ``parallel/constrain.py``, inside
the forward and backward. The dropout seed folds in the data rank, so the
masks on the replicated residual stream are equal on every rank of a model
group (else the replicated parameters would drift apart); the masks on a
rank's own heads and hidden features fold in its model rank too.
Checkpoints gather the whole state to rank 0, so ``state.pt`` keeps its
format: a tensor-parallel checkpoint restores in one process and the other
way round. Rank 0 alone logs and writes checkpoints, the others wait for it
at a barrier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import torch

from sd_video_gen_tpu_torch.codecs import add_sos, make_codec
from sd_video_gen_tpu_torch.config import (Config, add_device_flag,
                                           add_multihost_flags,
                                           build_arg_parser, load_config,
                                           strict_f32, sweep_grid)
from sd_video_gen_tpu_torch.models import build, default_device
from sd_video_gen_tpu_torch.models.text_embed import ClassNameEmbedder
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops.losses import LossWeights, composite_loss
from sd_video_gen_tpu_torch.ops.masks import causal_mask
from sd_video_gen_tpu_torch.parallel import (default_mesh_for_batch,
                                             multihost, sharding)
from sd_video_gen_tpu_torch.parallel.mesh import make_layout, parse_mesh_spec
from sd_video_gen_tpu_torch.train import checkpoint as ckpt
from sd_video_gen_tpu_torch.train.metrics import MetricsLogger
from sd_video_gen_tpu_torch.train.optim import Adam
from sd_video_gen_tpu_torch.utils.jit import jit

PRECISIONS = ("f32", "bf16", "bf16_full")


class TrainState:
    """The transformer's parameters (the module's own tensors), Adam's
    moments under the parameters' names, and the number of steps taken."""

    def __init__(self, model: torch.nn.Module, opt_state: dict, step: int = 0):
        self.params = dict(model.named_parameters())
        self.opt_state = opt_state
        self.step = step

    def state_dict(self) -> dict:
        """``{"step", "params", "mu", "nu"}`` over the live tensors (what
        ``train/checkpoint.py`` saves and restores)."""
        return {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "mu": self.opt_state["mu"], "nu": self.opt_state["nu"]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        live = self.state_dict()
        for tree in ("params", "mu", "nu"):
            if set(sd[tree]) != set(live[tree]):
                raise ValueError(
                    f"state {tree!r}: names differ from the train state's: "
                    f"{sorted(set(sd[tree]) ^ set(live[tree]))[:10]}")
            for k, v in live[tree].items():
                v.copy_(sd[tree][k])
        self.step = int(sd["step"])


@contextlib.contextmanager
def autotuned_convolutions():
    """cuDNN's benchmark mode while open: each convolution shape's fastest
    algorithm is timed once per process, at its first call, and kept. The
    heuristics otherwise choose by the allocator's largest cached block:
    for the f32 VAE encode of a 64 x 5-frame batch at 128px, FFT algorithms
    with tens of GiB of workspace where memory is free (1.55x slower), which
    a captured step would then hold for good."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = before


def encode_or_passthrough(codec, batch, use_sos: bool) -> torch.Tensor:
    """uint8 frames (B, T, H, W, 3) -> latents through the codec (its
    convolutions autotuned, ``autotuned_convolutions``); f32 (B, T, L)
    batches (from a ``LatentCacheDataset``) pass through with only the SOS
    handling. The codec is frozen: it runs without autograd, and its output
    enters the graph as a constant."""
    batch = torch.as_tensor(batch)
    with torch.no_grad():
        if batch.ndim == 3:  # pre-encoded latents
            latents = batch.to(codec.device, torch.float32)
            return add_sos(latents) if use_sos else latents
        with autotuned_convolutions():
            return codec.encode_batch(batch, use_sos=use_sos)


def _predictions_and_targets(model, latents, k: int, mode: str,
                             generator=None, text_embeds=None,
                             local_generator=None):
    """Shared forward logic for train and eval; returns (pred_k, target_k).
    Dropout follows the model's ``train()`` / ``eval()`` mode."""
    kwargs = {"generator": generator, "local_generator": local_generator}
    if text_embeds is not None:
        kwargs["text_embeds"] = text_embeds
    if mode in ("future", "learned_tgt"):
        # learned_tgt: the model ignores tgt and decodes its own learned
        # queries into exactly k outputs, so the same split applies
        y_in = latents[:, :-k]
        target = latents[:, -k:]
        pred = model(y_in, y_in, tgt_mask=None, **kwargs)
        return pred[:, -k:], target
    # ar / diff / text share the teacher-forced layout.
    y_in = latents[:, :-1]
    y_exp = latents[:, 1:]
    mask = causal_mask(y_in.shape[1], device=latents.device)
    pred = model(latents, y_in, tgt_mask=mask, **kwargs)
    pred_k = pred[:, -k:]
    if mode == "diff":
        pred_k = pred_k + latents[:, -(k + 1):-1]   # previous-frame latents
    return pred_k, y_exp[:, -k:]


def dropout_seed(seed: int, step: int, rank: int = 0,
                 model_rank: int | None = None) -> int:
    """The dropout generator's seed for step number ``step`` of a run seeded
    with ``seed``, on data rank ``rank``: a fixed function of the three, so
    the draws of a step do not depend on how the run reached it, and the
    processes of a data-parallel run draw other masks for their other
    samples (rank 0 draws what a single process does). With ``model_rank``:
    the seed of that model rank's own heads and hidden features."""
    out = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
           + int(rank) * 0xD6E8FEB86659FD93 + 0x94D049BB133111EB)
    if model_rank is not None:
        out += (int(model_rank) + 1) * 0xA0761D6478BD642F
    return out % (1 << 63)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _to_device(text_embeds, device):
    if text_embeds is None:
        return None
    return torch.as_tensor(text_embeds).to(device)


def _batch_to(frames, device) -> torch.Tensor:
    """A batch (uint8 frames or f32 latents) on ``device``: the host's part
    of a compiled program's input (a copy from the host cannot be
    captured)."""
    return torch.as_tensor(frames).to(device)


def make_train_step(model, codec, loss_w: LossWeights, cfg: Config,
                    mode: str = "ar", mu_dtype=None, layout=None):
    """Build (init_fn, step_fn) over ``model`` (a trainable
    ``FrameTransformer``) and the frozen ``codec``.

    ``init_fn()`` -> a fresh ``TrainState`` (zero moments, step 0).
    ``step_fn(state, frames, seed[, text_embeds])`` -> (state, components):
    one optimizer step in place; the components are 0-d tensors on the
    device (no synchronisation). ``mu_dtype`` goes to Adam. Loss terms are
    always computed in f32, whatever the model's compute dtype (GDL's
    differences and NCE's logits lose real precision in bf16).

    ``step_fn`` is the host part (dropout seed, the batch to the device,
    Adam's bias corrections, the step number) around ``step_impl`` (encode,
    forward, loss, gradient, the all-reduce, Adam in place), one ``jit``
    program (``step_fn.impl``: a CUDA graph per batch shape on the card,
    its state donated, its dropout generators registered, its collectives
    over ``layout``'s groups inside it, or eager where the backend cannot
    capture over them). In a process group
    the gradients are averaged over the ``data`` group of ``layout``
    (``parallel/mesh.py``; default: every process on ``data``), one
    all-reduce a step, before the update, and the data rank salts the
    dropout seed; the components stay this process's own. With a model
    axis, ``model`` is this rank's shard and the model rank salts the seed
    of the dropout on its own heads and features."""
    k = cfg.frames_to_predict
    use_sos = mode not in ("future", "learned_tgt")
    opt = Adam(cfg.lr, mu_dtype=mu_dtype)
    device = _device_of(model)
    layout = layout or make_layout()
    generator = torch.Generator(device=device)
    local = torch.Generator(device=device) if layout.model > 1 else None

    def init_fn() -> TrainState:
        return TrainState(model, opt.init(dict(model.named_parameters())))

    def step_impl(trees, frames, text_embeds):
        params, opt_state = trees
        names = list(params)
        with torch.enable_grad():
            latents = encode_or_passthrough(codec, frames, use_sos)
            pred_k, target_k = _predictions_and_targets(
                model, latents, k, mode, generator, text_embeds, local)
            total, comps = composite_loss(pred_k.float(), target_k.float(),
                                          loss_w)
            grads = torch.autograd.grad(total, [params[n] for n in names],
                                        allow_unused=True)
        if layout.data_group is not None:
            multihost.all_reduce_mean([g for g in grads if g is not None],
                                      "grads", layout.data_group)
        opt.update(params, dict(zip(names, grads)), opt_state)
        return {name: v.detach() for name, v in comps.items()}

    impl = jit(step_impl, name="step_impl", donate_argnums=0, grad=True,
               generators=[g for g in (generator, local) if g is not None],
               groups=layout.groups)

    def step_fn(state: TrainState, frames, seed: int, text_embeds=None):
        if not model.training:
            model.train()
        generator.manual_seed(dropout_seed(seed, state.step,
                                           layout.data_rank))
        if local is not None:
            local.manual_seed(dropout_seed(seed, state.step, layout.data_rank,
                                           layout.model_rank))
        opt.set_count(state.params, state.opt_state, state.step + 1)
        comps = impl((state.params, state.opt_state),
                     _batch_to(frames, device),
                     _to_device(text_embeds, device))
        state.step += 1
        return state, comps

    step_fn.impl = impl
    return init_fn, step_fn


def make_eval_step(model, codec, loss_w: LossWeights, cfg: Config,
                   mode: str = "ar", groups=()):
    """``eval_fn(frames[, text_embeds])`` -> the loss components of the
    model as it stands, without dropout or autograd; f32 loss math like the
    train side (bf16 GDL differences or NCE logits would make val_loss, and
    ``save_best`` with it, noisy). After the batch's copy to the device it
    is one ``jit`` program (``eval_fn.impl``, the JAX
    trainer's ``eval_impl``), captured with the model in ``eval()`` mode;
    ``groups``: those a sharded ``model``'s collectives run over."""
    k = cfg.frames_to_predict
    use_sos = mode not in ("future", "learned_tgt")
    device = _device_of(model)

    def eval_impl(frames, text_embeds):
        latents = encode_or_passthrough(codec, frames, use_sos)
        pred_k, target_k = _predictions_and_targets(
            model, latents, k, mode, None, text_embeds)
        return composite_loss(pred_k.float(), target_k.float(), loss_w)[1]

    impl = jit(eval_impl, name="eval_impl", groups=groups)

    @torch.no_grad()
    def eval_fn(frames, text_embeds=None):
        if model.training:
            model.eval()
        return impl(_batch_to(frames, device),
                    _to_device(text_embeds, device))

    eval_fn.impl = impl
    return eval_fn


def make_fvd_batch(model, codec, cfg: Config, mode: str = "ar", groups=()):
    """``fvd_batch(i3d, frames, text_embeds, protocol)`` -> the I3D
    statistics of one batch's generated and real clips, ``(n, Σx, Σxxᵀ)``
    each, the sums in f32 on the device (``FeatureStats.of_batch``): encode,
    teacher-forced predictions by ``protocol`` (``Trainer.fvd_validation``),
    decode, I3D at 224px. It is one ``jit`` program (the
    JAX trainer's ``fvd_batch``) per (I3D module, protocol, batch shape);
    ``frames`` must be on the device and the model in ``eval()`` mode;
    ``groups``: those a sharded ``model``'s collectives run over."""
    from sd_video_gen_tpu_torch.evaluation.fvd import (FeatureStats,
                                                       preprocess_videos)
    k = cfg.frames_to_predict

    def pad_time(v, min_t: int = 9):
        if v.shape[1] >= min_t:
            return v
        reps = -(-min_t // v.shape[1])
        return v.repeat(1, reps, 1, 1, 1)[:, :min_t]

    def stats(i3d, v):
        st = FeatureStats.of_batch(i3d(preprocess_videos(pad_time(v))))
        return st.n, st.raw_sum, st.raw_prod

    def fvd_batch(i3d, frames, text_embeds, protocol):
        latents = encode_or_passthrough(
            codec, frames, mode not in ("future", "learned_tgt"))
        if protocol == "reference":
            y_in = latents[:, :-1]
            kw = {} if text_embeds is None else {"text_embeds": text_embeds}
            pred = model(latents, y_in, tgt_mask=causal_mask(
                y_in.shape[1], device=latents.device), **kw)
            if mode == "diff":
                pred = pred + y_in    # the residual at every step
            real = frames
        else:
            pred, _ = _predictions_and_targets(model, latents, k, mode, None,
                                               text_embeds)
            real = frames[:, -k:]
        B, T = pred.shape[:2]
        dec = codec.decode_latents(pred.float().reshape(B * T,
                                                        codec.latent_dim))
        return stats(i3d, dec.reshape(B, T, *dec.shape[1:])), stats(i3d, real)

    return jit(fvd_batch, name="fvd_batch", groups=groups)


class _NoLogger:
    """The metrics stream of a process other than rank 0: nothing (rank 0
    logs the run, whose metrics every process holds alike)."""

    def log(self, metrics: dict, step: int | None = None) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """Fit a FrameTransformer on a frame dataset; owns state/ckpt/metrics.

    ``device`` defaults to the card and raises where there is none (the CPU
    has to be asked for: ``device='cpu'`` or ``--device cpu``); in a process
    group, the card is this rank's own. ``vae`` is the frozen
    ``AutoencoderKL`` of ``codec_kind='vae'`` (seeded random weights at SD
    widths when none is given). ``args.mesh`` (``--mesh``) lays out the
    process group (``parallel/mesh.make_layout``); the global batch must
    divide over its ``data`` axis."""

    def __init__(self, cfg: Config, args=None, mode: str = "ar",
                 codec_kind: str = "pixel", model_cfg=None,
                 checkpoint_dir: str = "./checkpoints", run_name=None,
                 use_wandb: bool = True, num_classes: int = 101,
                 vae=None, precision: str | None = None, device=None,
                 log_dir: str = "logs"):
        self.cfg = cfg
        self.args = args
        self.mode = mode
        self.precision = (precision if precision is not None
                          else getattr(args, "precision", "f32") or "f32")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision}")
        spec = getattr(args, "mesh", None) if args is not None else None
        # the mesh is the process group: the spec must describe it, and the
        # global batch must divide over its data axis
        self.layout = make_layout(spec)
        default_mesh_for_batch(cfg.batch_size, self.layout.data)
        self.rank = multihost.process_index()
        self.is_coordinator = multihost.is_coordinator()
        self.device = multihost.rank_device(default_device(
            device if device is not None else getattr(args, "device", None)))
        self.codec = make_codec(cfg, codec_kind, vae=vae, device=self.device)
        mc = model_cfg or FrameTransformerConfig.from_config(
            cfg, mode=mode if mode in ("future", "learned_tgt", "text")
            else "ar")
        if self.precision == "bf16":
            mc = dataclasses.replace(mc, compute_dtype=torch.bfloat16)
        self.model_cfg = mc
        self.loss_w = LossWeights.from_config(cfg)
        self.text_embedder = (
            ClassNameEmbedder(num_classes, mc.text_embed_dim,
                              device=self.device) if mode == "text" else None)

        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.index = ckpt.checkpoint_index(checkpoint_dir, cfg.config_name)
        self.run_name = run_name or f"{cfg.config_name}_{self.index}"
        debug = bool(getattr(args, "debug", False)) if args else False
        self.logger = (MetricsLogger(self.run_name, log_dir=log_dir,
                                     use_wandb=use_wandb and not debug)
                       if self.is_coordinator else _NoLogger())
        self._fvd_batch = None
        self.model = None
        self.state = None
        self.best_train = float("inf")
        self.best_val = float("inf")

    # -- state management ---------------------------------------------------
    def init_state(self, seed: int = 0):
        """Build the transformer from ``seed`` on the device, trainable, and
        a fresh train state over it (a torch module needs no sample batch to
        initialise, so the JAX trainer's sample arguments are gone)."""
        full = self.precision == "bf16_full"
        self.model = build(FrameTransformer, self.model_cfg, self.device,
                           torch.bfloat16 if full else torch.float32, seed,
                           trainable=True, shard=self.layout.shard)
        # where each parameter (and its moments) lives on the model axis
        self.placements = sharding.placements(
            "transformer", self.model.state_dict(), self.layout.model)
        self._init_fn, self._step_fn = make_train_step(
            self.model, self.codec, self.loss_w, self.cfg, self.mode,
            mu_dtype=torch.bfloat16 if full else None, layout=self.layout)
        model_groups = (self.layout.model_group,)
        self._eval_fn = make_eval_step(self.model, self.codec, self.loss_w,
                                       self.cfg, self.mode, model_groups)
        self._fvd_batch = make_fvd_batch(self.model, self.codec, self.cfg,
                                         self.mode, model_groups)
        # one after another: one memory pool
        self._eval_fn.impl.share_pool(self._step_fn.impl)
        self._fvd_batch.share_pool(self._step_fn.impl)
        self.state = self._init_fn()
        n = sum(p.numel() * (self.layout.model if self.placements[k] else 1)
                for k, p in self.state.params.items())
        self.logger.log({"event": "init", "n_params": n})
        return self.state

    def _shard(self, sd: dict) -> dict:
        """This rank's slice of a whole ``state_dict`` of the model."""
        return sharding.shard_state_dict(sd, self.placements,
                                         self.layout.model_rank,
                                         self.layout.model)

    def full_state(self) -> dict:
        """The whole train state (``TrainState.state_dict()`` form): this
        rank's own without a model axis, else gathered over the model
        group (every rank of the group takes part)."""
        sd = self.state.state_dict()
        shard = self.layout.shard
        if shard is None:
            return sd
        return {"step": sd["step"], **{
            tree: sharding.gather_state_dict(sd[tree], self.placements, shard)
            for tree in ("params", "mu", "nu")}}

    def resume(self, old_name: str):
        """Continue from the port's checkpoint directory ``old_name`` under
        ``checkpoint_dir`` (parameters, moments and step, exactly), or from a
        reference ``.pt`` state dict of the same name: the port's module
        names are the reference's own, so that is ``load_state_dict`` with
        fresh moments, like the reference's own resume."""
        path = os.path.abspath(os.path.join(self.checkpoint_dir, old_name))
        pt = path if path.endswith(".pt") else path + ".pt"
        if not os.path.isdir(path) and os.path.isfile(pt):
            sd = torch.load(pt, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
            # the positional table is a buffer the port generates, and text
            # mode's frozen sentence encoder is replaced by the embedding
            # table: neither is a parameter of this model
            sd = {k: v for k, v in sd.items()
                  if "positional_encoder" not in k
                  and not (self.mode == "text"
                           and k.startswith("sent_transformer."))}
            self.model.load_state_dict(self._shard(sd), strict=True)
        else:
            # the whole state (zero-stride stand-ins give its shapes and
            # dtypes), then this rank's slice
            trees = ("params", "mu", "nu")
            local = self.state.state_dict()
            like = {"step": 0, **{tree: {
                k: torch.empty((), dtype=v.dtype).expand(sharding.full_shape(
                    v.shape, self.placements[k], self.layout.model))
                for k, v in local[tree].items()} for tree in trees}}
            whole = ckpt.restore_checkpoint(path, like)
            self.state.load_state_dict({"step": whole["step"], **{
                tree: self._shard(whole[tree]) for tree in trees}})

    # -- loops --------------------------------------------------------------
    def _texts(self, indices):
        if self.text_embedder is None:
            return None
        ids = [i[0] if isinstance(i, (list, tuple)) else i for i in indices]
        # ids come from the host, so the bounds check and the gather start
        # no device -> host copy
        return self.text_embedder(np.asarray(ids, np.int64))

    @staticmethod
    def _means(keys, sums, nb: int, suffix: str) -> dict:
        """One device -> host fetch for the whole epoch. 'L1' capitalisation
        matches the reference's metric names."""
        if sums is None:
            return {}
        means = (sums / max(nb, 1)).tolist()
        return {f"{'L1' if k == 'l1' else k}_{suffix}": v
                for k, v in zip(keys, means)}

    def _reduced(self, sums):
        """The epoch's loss sums averaged over the data ranks: each summed
        the means of its own slices, so the average is the sum of the
        global batches' means."""
        if self.layout.data_group is not None and sums is not None:
            multihost.all_reduce_mean([sums], "metrics",
                                      self.layout.data_group)
        return sums

    def train_loop(self, loader, seed: int = 0):
        from sd_video_gen_tpu_torch.utils.profiling import StepTimer
        timer = StepTimer()
        keys, sums, nb = None, None, 0
        for indices, frames in loader:
            timer.start()
            frames = multihost.global_batch_from_local(frames, self.device)
            self.state, comps = self._step_fn(self.state, frames, seed,
                                              self._texts(indices))
            timer.stop()
            keys = list(comps)
            stacked = torch.stack([comps[k] for k in keys])
            sums = stacked if sums is None else sums + stacked
            nb += 1
        out = self._means(keys, self._reduced(sums), nb, "train")
        out.update(timer.summary())
        return out

    def validation_loop(self, loader):
        keys, sums, nb = None, None, 0
        for indices, frames in loader:
            frames = multihost.global_batch_from_local(frames, self.device)
            comps = self._eval_fn(frames, self._texts(indices))
            keys = list(comps)
            stacked = torch.stack([comps[k] for k in keys])
            sums = stacked if sums is None else sums + stacked
            nb += 1
        if sums is None:
            warnings.warn(
                "validation epoch yielded no batches (dataset smaller than "
                "one batch?) — val metrics report 0", stacklevel=2)
        return self._means(keys, self._reduced(sums), nb, "val")

    @torch.no_grad()
    def fvd_validation(self, loader, i3d, max_batches: int = 8,
                       protocol: str = "last_k") -> float:
        """In-training FVD on teacher-forced predictions (no dropout).

        ``i3d`` is the I3D module (``evaluation/predict_fvd.load_i3d``).
        ``protocol`` picks the frames that enter the statistics:
          - ``last_k``: the k predicted frames against the last k frames of
            the ground truth;
          - ``reference``: the reference's full-clip streaming, the
            teacher-forced prediction at every position (the SOS token
            anchors position 0) against the whole clip.
        ``future`` / ``learned_tgt`` emit exactly k frames, so ``reference``
        falls back to ``last_k`` there with a warning. Clips shorter than
        I3D's 9 frames are tiled in time, identically on both sides. A
        batch is one program (``make_fvd_batch``); its sums merge on the
        host in f64."""
        from sd_video_gen_tpu_torch.evaluation.fvd import (FeatureStats,
                                                           compute_fvd)
        if protocol not in ("last_k", "reference"):
            raise ValueError(f"unknown fvd protocol {protocol!r}")
        if protocol == "reference" and self.mode in ("future", "learned_tgt"):
            warnings.warn(
                f"fvd protocol 'reference' undefined for mode={self.mode} "
                "(single-shot models emit exactly k frames); using last_k",
                stacklevel=2)
            protocol = "last_k"
        model = self.model
        was_training = model.training
        model.eval()
        st_real, st_gen = FeatureStats(400), FeatureStats(400)
        try:
            for bi, (indices, frames) in enumerate(loader):
                if bi >= max_batches:
                    break
                if np.ndim(frames) == 3:
                    raise ValueError(
                        "in-training FVD needs PIXEL frames (I3D consumes "
                        "video), but the loader yields pre-encoded latents "
                        "— --latent_cache cannot be combined with "
                        "--fvd_every")
                frames = multihost.global_batch_from_local(frames,
                                                           self.device)
                gen, real = self._fvd_batch(i3d, frames,
                                            self._texts(indices), protocol)
                st_gen = st_gen.merge(FeatureStats(400, *gen))
                st_real = st_real.merge(FeatureStats(400, *real))
        finally:
            model.train(was_training)
        if self.layout.data_group is not None:
            st_real, st_gen = (self._pooled(st) for st in (st_real, st_gen))
        return compute_fvd(st_real, st_gen)

    def _pooled(self, st):
        """FVD statistics over every data rank's clips: the mean over the
        data ranks of (n, sum, sum of outer products), whose mean and
        covariance are the pooled ones (the JAX trainer streams the
        assembled global batch)."""
        from sd_video_gen_tpu_torch.evaluation.fvd import FeatureStats
        parts = [torch.as_tensor(np.asarray(a, np.float64), device=self.device)
                 for a in (st.n, st.raw_sum, st.raw_prod)]
        multihost.all_reduce_mean(parts, "fvd_stats", self.layout.data_group)
        n, raw_sum, raw_prod = (p.cpu().numpy() for p in parts)
        return FeatureStats(st.dim, np.float64(n), raw_sum, raw_prod)

    def fit(self, train_loader, val_loader, epochs: int, seed: int = 0,
            save_best: bool = False, fvd_every: int = 0, fvd_i3d=None,
            ckpt_every: int = 1, fvd_protocol: str = "last_k"):
        if self.state is None:
            self.init_state(seed=seed)
        history = []
        try:
            for epoch in range(1, epochs + 1):
                train_m = self.train_loop(train_loader, seed)
                val_m = self.validation_loop(val_loader)
                metrics = {"epoch": epoch, **train_m, **val_m,
                           "train_loss": train_m.get("total_train", 0.0),
                           # an EMPTY val epoch must not report 0.0: under
                           # save_best that would pin best_val to 0.0 and
                           # crown a bogus 'best' forever (NaN never
                           # compares < best)
                           "val_loss": val_m.get("total_val", float("nan"))}
                # periodic in-training FVD (the reference's epoch % 5 == 1)
                if fvd_every and fvd_i3d is not None and (
                        fvd_every == 1 or epoch % fvd_every == 1):
                    metrics["FVD score"] = self.fvd_validation(
                        val_loader, fvd_i3d, protocol=fvd_protocol)
                self.logger.log(metrics, step=self.state.step)
                history.append(metrics)
                # --ckpt_every: a full train-state save moves parameters and
                # Adam state (GBs at flagship scale). The final epoch always
                # saves. save_best must see EVERY epoch's metrics (it already
                # rate-limits itself by writing only on improvement): gating
                # it on ckpt_every would skip the true best epoch and let a
                # later, worse epoch claim the 'best' checkpoint.
                if save_best or epoch % max(ckpt_every, 1) == 0 \
                        or epoch == epochs:
                    self._save(metrics, save_best)
                    multihost.barrier()   # rank 0 has started the save
            # drain the epoch save in flight before declaring fit done
            ckpt.finalize_saves()
            multihost.barrier()           # ... and written it
        except (KeyboardInterrupt, SystemExit, Exception) as e:
            # failure/preemption handling: persist an emergency checkpoint
            # (parameters + moments + step) so --resume continues exactly.
            # Not with a model axis: gathering the shards needs every rank
            # of the group, and a failure need not have reached them all
            if self.state is not None and self.layout.shard is None:
                path = self.save("interrupt")
                self.logger.log({"event": "interrupt",
                                 "error": type(e).__name__,
                                 "checkpoint": path})
            raise
        return history

    def _save(self, metrics, save_best: bool):
        # save-best on train and val separately, else save-last. Epoch saves
        # do not block: the state is copied to host memory and the disk
        # write overlaps the next epochs; fit() and the interrupt path drain
        # with ckpt.finalize_saves().
        if save_best:
            if metrics["train_loss"] < self.best_train:
                self.best_train = metrics["train_loss"]
                self.save("train", block=False)
            if metrics["val_loss"] < self.best_val:
                self.best_val = metrics["val_loss"]
                self.save("test", block=False)
        else:
            self.save("test", block=False)

    def save(self, mode_tag: str, block: bool = True):
        """Write the whole train state (``full_state``; rank 0 writes it:
        every data rank holds the same one); returns the checkpoint's
        path. With a model axis every rank must call it."""
        path = ckpt.checkpoint_path(self.checkpoint_dir, self.cfg.config_name,
                                    self.index, mode_tag)
        state = self.full_state()
        if self.is_coordinator:
            ckpt.save_checkpoint(path, state, block=block)
        return path


class _LabelMappedLoader:
    """Yield (labels, frames) from a ``NativeBatchLoader``, which yields clip
    indices, through ITS OWN split's clip -> class table: the contract
    ``BatchLoader`` keeps for class datasets."""

    def __init__(self, loader):
        self.loader = loader
        self.labels = loader.labels

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for ids, frames in self.loader:
            yield [self.labels[int(i)] for i in ids], frames


def build_dataset(cfg: Config, args, stage: str,
                  exact_frames: int | None = None):
    """Dataset dispatch. ``exact_frames`` pins the clip length, overriding
    every mode-based extension (future/learned_tgt add frames_to_predict;
    Kitti always extends): evaluation callers that compute their own GT
    horizon pass it so the length policy has exactly one owner."""
    from sd_video_gen_tpu_torch.data import (BouncingBallDataset,
                                             KittiDataset,
                                             MovingMNISTDataset)
    name = args.dataset
    # future/learned_tgt train on the split src=clip[:-k], target=clip[-k:]:
    # clips must carry the k extra frames or the encoder input is EMPTY
    ext = (cfg.frames_to_predict
           if getattr(args, "train_mode", "ar") in ("future", "learned_tgt")
           else 0)
    if name == "ball":
        return BouncingBallDataset(num_frames=exact_frames
                                   or (cfg.frames_per_clip + ext),
                                   stride=cfg.stride, dir=args.folder,
                                   stage=stage, seed=args.seed)
    if name == "kitti":
        return KittiDataset(
            num_frames=exact_frames
            or (cfg.frames_per_clip + cfg.frames_to_predict),
            stride=1, dir=args.folder, stage=stage,
            frame_size=cfg.frame_size, seed=args.seed)
    if name == "mnist":
        return MovingMNISTDataset(num_frames=exact_frames
                                  or (cfg.frames_per_clip + ext),
                                  stride=cfg.stride,
                                  path=args.folder or "mnist_test_seq.npy",
                                  stage=stage, seed=args.seed)
    if "ucf" in name:
        from sd_video_gen_tpu_torch.data.ucf101 import UCF101Dataset
        return UCF101Dataset.from_args(cfg, args, stage,
                                       exact_frames=exact_frames)
    raise ValueError(f"unknown dataset {name}")


def build_train_parser():
    """The shared flags plus the trainer's own (every flag of the JAX CLI)
    and ``--device``."""
    parser = build_arg_parser()
    parser.add_argument("--train_mode", type=str, default="ar",
                        choices=["ar", "future", "diff", "text",
                                 "learned_tgt"])
    parser.add_argument("--codec", type=str, default="pixel",
                        choices=["pixel", "vae"])
    parser.add_argument("--sweep", action="store_true",
                        help="run the full YAML grid instead of the first point")
    parser.add_argument("--fvd_every", type=int, default=0,
                        help="compute FVD every N epochs")
    parser.add_argument("--i3d_weights", type=str, default=None)
    parser.add_argument("--fvd_protocol", type=str, default="last_k",
                        choices=("last_k", "reference"))
    parser.add_argument("--latent_cache", type=str, default=None,
                        help="train from a utils/preprocess.py latent cache "
                             "dir instead of decoding frames")
    parser.add_argument("--native_cache", type=str, default=None,
                        help="feed batches through the C++ fastloader from a "
                             "data/native_loader.py frame cache dir")
    parser.add_argument("--ckpt_every", type=int, default=1,
                        help="checkpoint every N epochs (final epoch always "
                             "saves; a flagship train-state save moves GBs). "
                             "--save_best True ignores this: best-mode "
                             "writes only on improvement already")
    parser.add_argument("--precision", type=str, default="f32",
                        choices=list(PRECISIONS),
                        help="f32 | bf16 (bf16 compute, f32 master weights) "
                             "| bf16_full (bf16 weights + bf16 Adam moments)")
    return add_device_flag(add_multihost_flags(parser))


@multihost.releases_programs
def main(argv=None):
    """The trainer's CLI; returns the fit history of each grid point."""
    strict_f32()
    args = build_train_parser().parse_args(argv)
    if args.multihost:
        # before anything touches a device: the group picks this process's
        # card
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, args.device)
    if args.mesh:
        parse_mesh_spec(args.mesh)       # before anything is built

    from sd_video_gen_tpu_torch.data import BatchLoader

    grid = (sweep_grid(args.config, args.config_dir) if args.sweep
            else [load_config(args.config, args.config_dir)])
    vae = None
    if args.codec == "vae" and args.vae_weights:
        from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
        from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
        vae = build_from_file(
            AutoencoderKL, VAEConfig(), "vae", args.vae_weights,
            multihost.rank_device(default_device(args.device)))
    fvd_i3d = None
    histories = []
    for cfg in grid:
        trainer = Trainer(cfg, args, mode=args.train_mode,
                          codec_kind=args.codec,
                          checkpoint_dir=args.checkpoint_dir, vae=vae)
        if args.fvd_every and fvd_i3d is None:
            from sd_video_gen_tpu_torch.evaluation.predict_fvd import load_i3d
            fvd_i3d = load_i3d(args.i3d_weights, trainer.device)
        # every process derives the same global epoch order from the shared
        # seed and loads only its data rank's contiguous slice of each
        # global batch (both loaders keep that contract); ragged tails trim
        # to a multiple of the data axis
        count = trainer.layout.data
        shard = (trainer.layout.data_rank, count) if count > 1 else None
        if args.native_cache:
            from sd_video_gen_tpu_torch.data.native_loader import (
                NativeBatchLoader)
            train_loader = NativeBatchLoader(
                args.native_cache, "train", cfg.batch_size,
                epoch_ratio=cfg.epoch_ratio, flip=args.flip, seed=args.seed,
                n_threads=max(1, cfg.num_workers),
                process_shard=shard, shard_multiple=count)
            val_loader = NativeBatchLoader(
                args.native_cache, "test", cfg.batch_size,
                epoch_ratio=cfg.epoch_ratio, seed=args.seed,
                n_threads=max(1, cfg.num_workers),
                process_shard=shard, shard_multiple=count)
            if args.train_mode == "text":
                if train_loader.labels is None or val_loader.labels is None:
                    raise ValueError(
                        "--train_mode text needs class labels, but this "
                        "native cache has none (built from a no-class "
                        "dataset, or predates label storage — rebuild it "
                        "with data.native_loader)")
                # each split has its own clip -> class table (val indices
                # through the train table would condition validation on the
                # wrong classes)
                train_loader = _LabelMappedLoader(train_loader)
                val_loader = _LabelMappedLoader(val_loader)
        else:
            if args.latent_cache:
                from sd_video_gen_tpu_torch.data.latent_cache import (
                    LatentCacheDataset)
                train_ds = LatentCacheDataset(args.latent_cache, "train")
                val_ds = LatentCacheDataset(args.latent_cache, "test")
            else:
                train_ds = build_dataset(cfg, args, "train")
                val_ds = build_dataset(cfg, args, "test")
            train_loader = BatchLoader(train_ds, cfg.batch_size,
                                       epoch_ratio=cfg.epoch_ratio,
                                       seed=args.seed, process_shard=shard,
                                       shard_multiple=count)
            val_loader = BatchLoader(val_ds, cfg.batch_size,
                                     epoch_ratio=cfg.epoch_ratio,
                                     seed=args.seed, process_shard=shard,
                                     shard_multiple=count)
        if args.resume:   # on every process
            trainer.init_state(seed=args.seed)
            trainer.resume(args.old_name)
        histories.append(trainer.fit(
            train_loader, val_loader, epochs=cfg.epochs, seed=args.seed,
            save_best=args.save_best, fvd_every=args.fvd_every,
            fvd_i3d=fvd_i3d, ckpt_every=args.ckpt_every,
            fvd_protocol=args.fvd_protocol))
        trainer.logger.close()
    return histories


if __name__ == "__main__":
    main()
