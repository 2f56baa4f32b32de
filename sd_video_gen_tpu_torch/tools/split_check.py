"""Does a data-parallel step's gradient differ from one process's by more
than the rounding of a sum's order? ``train_flagship``'s FrameTransformer
and loss in f32 at dropout 0, one batch of clips:

  1. the gradient of the whole batch (one process);
  2. the mean of the gradients of its ``--slices`` equal slices (what the
     ``data`` axis's all-reduce of each rank's mean gradient computes);
  3. the gradient of the same batch with its clips in reverse order (the
     same sum in another order: the yardstick of f32 rounding).

Per parameter tensor, the relative L2 of 2 and of 3 against 1. Adam's
first moment after one step is 0.1 times the gradient, so these are the
relative L2s ``chip_smoke.py``'s tp phase reads on the moments after step 1.
``sliced_step`` trains on 2 in one process (that phase's yardstick of the
data-parallel run).

``--reference f64`` adds the exact answer: the gradient of the whole batch
with the model and its inputs (the codec's f32 latents) cast to float64,
every product, attention and loss in f64 (``ops/losses.wide``), on the same
device. Each of 1-3 is then read against it, per tensor and over all
tensors at once, and so are the loss components (2's: the mean of the
slices'); the attentions' fused input projections are also read a third at
a time (``[q]``, ``[k]``, ``[v]``): a key bias moves no softmax, so its
exact gradient is 0 and its f32 one is rounding alone. ``--products`` reads
every matrix product of the step (each ``F.linear`` and ``torch.einsum`` of
the model and the losses, and the gradient of its output) at the whole
batch's shapes and at one slice's against f64: a product that computes
below f32 at one of the two shapes shows there. Each forward row also
counts the outputs on the other side of 0 from f64's (``*_flips``): past a
ReLU (the feed-forward's) or an ``|x|`` (GDL's), such an element's gradient
differs by its whole value, however small the rounding that moved it.

    python -m sd_video_gen_tpu_torch.tools.split_check [--batch 24]
        [--slices 4] [--frames square|noise] [--reference f64 [--products]]
        [--top 5] [--device cpu]

prints one JSON line: the worst tensors of 2 against 1, each with its
yardstick, and the largest of each over all tensors (with ``--reference``,
an ``f64`` entry as well; with ``--products``, a ``products`` entry).
``square``: black frames, a bright 32 x 32 square moving across each clip
(the training data of ``chip_smoke.py``'s data and tp phases); ``noise``:
uniform uint8.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json

import numpy as np
import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.config import strict_f32
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops.losses import (LossWeights, composite_loss,
                                               wide)
from sd_video_gen_tpu_torch.tools.bench_harness import TRAIN_PATHS
from sd_video_gen_tpu_torch.train.optim import Adam
from sd_video_gen_tpu_torch.train.trainer import (_predictions_and_targets,
                                                  encode_or_passthrough)

PATH = next(p for p in TRAIN_PATHS if p["name"] == "train_flagship")


def clips(kind: str, batch: int, frames: int, size: int,
          seed: int = 0) -> np.ndarray:
    """(batch, frames, size, size, 3) uint8 clips of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (batch, frames, size, size, 3),
                            dtype=np.uint8)
    # at 128px: a 32px square from (8..71, 8..71), drifting up to 40px
    out = np.zeros((batch, frames, size, size, 3), np.uint8)
    side, edge, drift = size // 4, size // 16, 5 * size // 16
    for b in range(batch):
        (y, x) = rng.integers(edge, size - side - 3 * edge, 2)
        (dy, dx) = rng.integers(-6, 7, 2)
        for t in range(frames):
            ty, tx = y + (dy * t) % drift, x + (dx * t) % drift
            out[b, t, ty:ty + side, tx:tx + side] = rng.integers(96, 256)
    return out


def gradients(model, codec, loss_w, k: int, batch,
              dtype=torch.float32) -> tuple[dict, dict]:
    """Each parameter's gradient of the batch's loss (its mean over the
    clips), as the train step computes it, and the loss components; the
    latents cast to ``dtype`` (the model's)."""
    latents = encode_or_passthrough(codec, batch, True).to(dtype)
    pred, target = _predictions_and_targets(model, latents, k, "ar")
    total, comps = composite_loss(wide(pred), wide(target), loss_w)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return ({n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)},
            {n: float(v.detach()) for n, v in comps.items()})


def slice_mean(model, codec, loss_w, k: int, batch,
               slices: int) -> tuple[dict, dict]:
    """The mean of the gradients, and of the loss components, of
    ``batch``'s ``slices`` equal slices, each its own forward and backward
    (``gradients``): what the ``data`` axis's all-reduce of each rank's
    mean gradient computes, in one process."""
    if len(batch) % slices:
        raise ValueError(f"{len(batch)} clips do not split in {slices}")
    rows = len(batch) // slices
    grads = comps = None
    for i in range(slices):
        g, c = gradients(model, codec, loss_w, k,
                         batch[i * rows:(i + 1) * rows])
        grads = g if grads is None else {n: grads[n] + v
                                         for n, v in g.items()}
        comps = c if comps is None else {n: comps[n] + v
                                         for n, v in c.items()}
    return ({n: v / slices for n, v in grads.items()},
            {n: v / slices for n, v in comps.items()})


def sliced_step(model, codec, loss_w, cfg, slices: int):
    """A step function as ``trainer.make_train_step`` builds one
    (``step(state, frames, seed) -> (state, components)``, mode ``ar``,
    dropout 0, f32 moments), eager, that applies the trainer's Adam to each
    batch's ``slice_mean``: a ``data`` axis of size ``slices`` in one
    process, but for the all-reduce's order (``chip_smoke.py``'s yardstick
    of the data-parallel step's rounding)."""
    opt = Adam(cfg.lr)
    device = next(model.parameters()).device

    def step(state, frames, seed, text_embeds=None):
        if text_embeds is not None:
            raise ValueError("the sliced step is mode ar: it takes no text")
        model.train()
        frames = torch.as_tensor(np.asarray(frames) if not isinstance(
            frames, torch.Tensor) else frames).to(device)
        with torch.enable_grad():
            grads, comps = slice_mean(model, codec, loss_w,
                                      cfg.frames_to_predict, frames, slices)
        opt.update(state.params, grads, state.opt_state, state.step + 1)
        state.step += 1
        return state, {n: torch.tensor(v, dtype=torch.float32, device=device)
                       for n, v in comps.items()}
    return step


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.double()
    return float((a.double() - b).norm() / b.norm()) if b.norm() else 0.0


def _thirds(grads: dict) -> dict:
    """``grads`` with each fused input projection's q, k and v rows as
    tensors of their own as well."""
    out = dict(grads)
    for n, g in grads.items():
        if n.endswith("in_proj_weight") or n.endswith("in_proj_bias"):
            for part, t in zip("qkv", g.chunk(3, dim=0)):
                out[f"{n}[{part}]"] = t
    return out


def against(runs: dict, exact: dict, losses: dict, exact_losses: dict,
            top: int) -> dict:
    """Each run of ``runs`` ({name: gradients}) against the ``exact``
    gradients: per tensor (the fused projections' thirds too; the worst
    ``top`` by the largest of the runs, and by the largest ratio of a run
    to the first run), over all tensors at once, and the loss components'
    relative differences. A key bias's third is left out of the per-tensor
    readings (its exact gradient is 0, so its f32 one, rounding alone, has
    no relative error); it stays in its whole tensor."""
    exact = {n: v for n, v in _thirds(exact).items()
             if not n.endswith("in_proj_bias[k]")}
    runs = {r: _thirds(g) for r, g in runs.items()}
    rel = {r: {n: _rel(g[n], v) for n, v in exact.items()}
           for r, g in runs.items()}
    first = next(iter(runs))
    ratio = {n: max(rel[r][n] for r in runs) / max(rel[first][n], 1e-300)
             for n in exact}
    row = lambda n: dict({f"{r}_rel_l2": rel[r][n] for r in runs},
                         tensor=n)
    whole = torch.cat([v.double().reshape(-1) for n, v in exact.items()
                       if "[" not in n])
    out = {"worst": [row(n) for n in sorted(
               exact, key=lambda n: -max(rel[r][n] for r in runs))[:top]],
           "worst_ratio": [dict(row(n), ratio=ratio[n]) for n in sorted(
               exact, key=lambda n: -ratio[n])[:top]]}
    for r, g in runs.items():
        out[f"max_{r}_rel_l2"] = max(rel[r].values())
        out[f"all_{r}_rel_l2"] = _rel(torch.cat(
            [g[n].double().reshape(-1) for n in exact if "[" not in n]),
            whole)
        out[f"{r}_loss_rel"] = {
            k: abs(losses[r][k] - v) / abs(v) if v else 0.0
            for k, v in exact_losses.items()}
    return out


@contextlib.contextmanager
def traced_products(outs: list, grads: dict):
    """Inside it, every ``F.linear`` and ``torch.einsum`` of the model and
    the losses appends (its name, its output) to ``outs``, and the
    backward pass puts the gradient of that output in ``grads`` under its
    index."""
    real = (F.linear, torch.einsum)

    def keep(name, y):
        i = len(outs)
        outs.append((name, y.detach()))
        if y.requires_grad:
            y.register_hook(lambda g: grads.__setitem__(i, g.detach()))
        return y

    F.linear = lambda x, w, b=None: keep(
        f"linear {tuple(w.shape)}", real[0](x, w, b))
    torch.einsum = lambda eq, *ops: keep(f"einsum {eq}", real[1](eq, *ops))
    try:
        yield
    finally:
        F.linear, torch.einsum = real


def products(cfg, batch: np.ndarray, slices: int, device,
             top: int = 5, seed: int = 0) -> dict:
    """Every product of the forward (and the gradient of its output, from
    the backward's products) of the whole batch and of its first slice in
    f32, against the whole batch's in f64 on the slice's rows: does any
    product at one of the two shapes compute below f32? (A slice's loss is
    a mean over fewer clips: its output gradients are ``slices`` times the
    whole batch's, exactly.)"""
    model, codec, loss_w, k = _model(cfg, device, seed)
    rows = len(batch) // slices
    runs = {}
    for name, m, b, dtype in (
            ("f64", copy.deepcopy(model).double(), batch, torch.float64),
            ("whole", model, batch, torch.float32),
            ("slice", model, batch[:rows], torch.float32)):
        outs, grads = [], {}
        with traced_products(outs, grads):
            gradients(m, codec, loss_w, k, b, dtype)
        runs[name] = (outs, grads)
    exact, exact_g = runs["f64"]
    table = {"forward": [], "backward": []}
    for i, (name, y) in enumerate(exact):
        def cut(t, scale=1.0):       # the first slice's rows
            return t[:t.shape[0] * rows // len(batch)] * scale
        got = {"whole": cut(runs["whole"][0][i][1]),
               "slice": runs["slice"][0][i][1]}
        fwd = {r: _rel(v, cut(y)) for r, v in got.items()}
        # outputs on the other side of 0 from f64's: where a ReLU or an
        # |x| follows, their gradients part by the whole value
        fwd.update({f"{r}_flips": int(((v > 0) != (cut(y) > 0)).sum())
                    for r, v in got.items()})
        table["forward"].append(dict(fwd, product=name, index=i))
        if i in exact_g:
            bwd = {"whole": _rel(cut(runs["whole"][1][i]), cut(exact_g[i])),
                   "slice": _rel(runs["slice"][1][i],
                                 cut(exact_g[i], float(slices)))}
            table["backward"].append(dict(bwd, product=name, index=i))
    out = {"products": len(exact), "rows": rows,
           "flips": {r: {t["index"]: t[f"{r}_flips"] for t in table[
               "forward"] if t[f"{r}_flips"]} for r in ("whole", "slice")}}
    for part, got in table.items():
        out[f"{part}_max"] = {r: max(t[r] for t in got)
                              for r in ("whole", "slice")}
        out[f"{part}_worst_ratio"] = sorted(
            got, key=lambda t: -t["slice"] / max(t["whole"], 1e-300))[:top]
        out[f"{part}_worst"] = sorted(
            got, key=lambda t: -max(t["whole"], t["slice"]))[:top]
    return out


def _model(cfg, device, seed):
    mc = FrameTransformerConfig.from_config(cfg.replace(dropout_p=0.0),
                                            mode="ar")
    model = build(FrameTransformer, mc, device, torch.float32, seed,
                  trainable=True)
    return (model, PixelCodec(cfg.frame_size, device),
            LossWeights.from_config(cfg), cfg.frames_to_predict)


def check(cfg, batch: np.ndarray, slices: int, device, top: int = 5,
          seed: int = 0, reference: str | None = None) -> dict:
    """The three gradients of ``batch`` under ``cfg``'s model and loss, and
    the per-tensor comparison; with ``reference="f64"`` each also against
    the f64 gradient of the whole batch."""
    args = _model(cfg, device, seed)
    model = args[0]
    whole, whole_l = gradients(*args, batch)
    split, split_l = slice_mean(*args, batch, slices)
    order, order_l = gradients(*args, np.ascontiguousarray(batch[::-1]))
    rows = sorted(((_rel(split[n], v), _rel(order[n], v), n)
                   for n, v in whole.items()), reverse=True)
    out = {"clips": len(batch), "slices": slices,
           "worst": [{"tensor": n, "split_rel_l2": s, "order_rel_l2": o}
                     for s, o, n in rows[:top]],
           "max_split_rel_l2": rows[0][0],
           "max_order_rel_l2": max(o for _, o, _ in rows)}
    if reference is None:
        return out
    if reference != "f64":
        raise ValueError(f"unknown reference {reference!r}")
    exact, exact_l = gradients(copy.deepcopy(model).double(), *args[1:],
                               batch, torch.float64)
    out["f64"] = against({"whole": whole, "split": split, "order": order},
                         exact, {"whole": whole_l, "split": split_l,
                                 "order": order_l}, exact_l, top)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=24)
    parser.add_argument("--slices", type=int, default=4)
    parser.add_argument("--frames", choices=("square", "noise"),
                        default="square")
    parser.add_argument("--frame", type=int, default=None,
                        help="frame size (default: the path's 128)")
    parser.add_argument("--reference", choices=("f64",), default=None,
                        help="also read each gradient against the whole "
                             "batch's in float64")
    parser.add_argument("--products", action="store_true",
                        help="with --reference f64: also every product's "
                             "output and output gradient at the whole "
                             "batch's and one slice's shapes")
    parser.add_argument("--top", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    strict_f32()
    cfg = PATH["cfg"].replace(batch_size=args.batch)
    if args.frame is not None:
        cfg = cfg.replace(frame_size=args.frame)
    batch = clips(args.frames, args.batch, PATH["clip_frames"],
                  cfg.frame_size)
    out = check(cfg, batch, args.slices, torch.device(args.device),
                args.top, reference=args.reference)
    if args.products:
        out["products"] = products(cfg, batch, args.slices,
                                   torch.device(args.device), args.top)
    out["frames"] = args.frames
    if torch.device(args.device).type == "cuda":
        out["device"] = torch.cuda.get_device_name()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
