"""Training steps back to back through the port's ``Trainer`` and its
compiled step, on batches fed from the host as a loader's are.

Set-up builds the Trainer with the configuration's precision and losses,
fills the transformer with the run's weights, and takes the first three
steps through the window's own call and feed (``Trainer.train_loop``, one
batch each, all different), keeping what the comparison needs: each
step's loss components, Adam's first moments after step 1 (the first
gradient is mu / (1 - b1)), and the parameters before step 1 and after
step 3. That same Trainer then trains through the window: the loader
yields the run's batches in turn until ``--seconds`` have passed, and the
window closes when the loop has fetched its losses.
``train_clips_per_s`` is the clips of every step over the window's
length. With ``--trace 1`` the first ``trace_units`` steps of the window
run under the profiler, whose events are read once the window has closed.

The comparison runs the plain reference through the same three steps from
the same weights, batches and dropout draws (the reference seeds its
dropout generator as the trainer does, from the run's seed and the step).
Four numbers are compared. ``loss1_rel``: the widest relative gap of the
first step's loss components; ``loss_rel_3_steps``: the same over the
three steps (Adam's first steps move each weight by about the learning
rate whatever the gradient's size, so rounding that flips a small
gradient's sign moves the later losses, and its limit is wider).
``grad1_gap_clip_leaves``: over the tenth of the leaves whose gradient
depends most on which clips are in the batch (the lowest coherence of the
first batch's per-clip reference gradients), the median of each leaf's
gap between the program's and the reference's norms of the first
gradient; a batch of other clips, or fewer, moves those norms together,
where rounding moves them apart. ``update_norm_gap``: the worst leaf's
gap between the norms of the parameters' change over the three steps. A
leaf's gap is taken over the reference's norm of that leaf or of the
median leaf, whichever is larger; both leave out leaves whose reference
gradient is under a thousandth of the median leaf's (a key's bias under
softmax moves by round-off alone). The worst leaf's gradient gap is
printed beside them and not compared: the float8 control reads under
twice what sound runs read there.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import harness, roofline
from benchmark import traffic as TR
from benchmark import weights
from benchmark.drivers.predict_closed import free, traced
from benchmark.reference import pipeline as P
from benchmark.reference.transformer import (FrameTransformer,
                                              FrameTransformerConfig)
from benchmark.trace import BUCKETS

DTYPES = {"bf16_full": torch.bfloat16, "f32": torch.float32}
# How a rank other than 0 is started: this module's ``main``.
WORKER = [sys.executable, "-m", "benchmark.drivers.train"]
LOSSES = ("mse", "gdl", "contrastive", "total")


def model_config(cfg: dict, frame_size: int) -> FrameTransformerConfig:
    return FrameTransformerConfig(latent_dim=4 * (frame_size // 8) ** 2,
                                  **cfg["transformer"])


def _host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def build_trainer(cfg: dict, tr: dict, seed: int, device, workdir: str):
    from sd_video_gen_tpu_torch.config import Config, strict_f32
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    strict_f32()
    tf, loss = cfg["transformer"], cfg["losses"]
    c = Config(config_name=cfg["name"], lr=cfg["lr"],
               batch_size=tr["clips_per_step"],
               frames_per_clip=cfg["frames_per_clip"],
               frames_to_predict=cfg["frames_to_predict"],
               frame_size=tr["frame_size"], dim_model=tf["dim_model"],
               num_heads=tf["num_heads"],
               num_encoder_layers=tf["num_encoder_layers"],
               num_decoder_layers=tf["num_decoder_layers"],
               dropout_p=tf["dropout_p"], use_mse=loss["use_mse"],
               use_gdl=loss["use_gdl"], lambda_gdl=loss["lambda_gdl"],
               use_contrastive=loss["use_contrastive"],
               lambda_contrastive=loss["lambda_contrastive"])
    trainer = Trainer(c, mode="ar", codec_kind="pixel",
                      checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      log_dir=os.path.join(workdir, "logs"), use_wandb=False,
                      precision=cfg["precision"], device=device)
    trainer.logger.quiet = True
    trainer.init_state(seed=0)
    shapes = weights.shapes_of(roofline.meta_module(
        FrameTransformer, model_config(cfg, tr["frame_size"])))
    weights.load(trainer.model, weights.seeded(
        shapes, seed, "transformer", device, DTYPES[cfg["precision"]],
        cfg.get("init_spread")))
    return trainer


def _step_losses(means: dict) -> dict:
    return {k: means[f"{k}_train"] for k in LOSSES}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_summary(trace) -> dict:
    return {"busy_s": trace.busy_s(), "window_s": trace.window_s,
            "idle": trace.idle_share(),
            "collectives_s": trace.seconds_matching(
                dict(BUCKETS)["collectives"]),
            "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if torch.cuda.is_available() else 0)}


def train(run, rank: int = 0, world: int = 1, port: int = 0):
    """This rank's part of the run: set-up, the first three steps, the
    window. Across ``world`` processes each rank trains on its rows of
    every batch, and the window runs in chunks of the traffic's ``chunk``
    steps, after each of which rank 0's clock decides for every rank
    whether to go on.
    Rank 0 fills ``run`` and returns what the comparison needs."""
    from sd_video_gen_tpu_torch.parallel import multihost
    cfg, tr = run.config, run.traffic
    if world > 1:
        multihost.initialize(f"localhost:{port}", world, rank, run.device)
    device = multihost.rank_device(torch.device(run.device))
    per = tr["clips_per_step"] // world
    batches = [b[rank * per:(rank + 1) * per].copy()
               for b in TR.train_batches(tr, run.seed)]
    workdir = tempfile.TemporaryDirectory(prefix="sdvg-bench-")
    trainer = build_trainer(cfg, tr, run.seed, device, workdir.name)
    idx = list(range(per))
    first = {"p0": _host(trainer.state.params), "losses": []}
    for s in range(3):
        first["losses"].append(_step_losses(trainer.train_loop(
            [(idx, batches[s])], seed=run.seed)))
        if s == 0:
            first["mu1"] = _host(trainer.state.opt_state["mu"])
    first["p3"] = _host(trainer.state.params)
    steps = 3

    def loader(n=None, until=None):
        nonlocal steps
        i = 0
        while (i < n) if n is not None else (time.perf_counter() < until):
            yield idx, batches[steps % len(batches)]
            steps += 1
            i += 1

    def traced_steps():
        trainer.train_loop(loader(n=tr["trace_units"]), seed=run.seed)

    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    tracer = traced(tr["trace_units"], traced_steps) if run.traced else None
    if world == 1:
        trainer.train_loop(loader(until=t0 + run.seconds), seed=run.seed)
    else:
        go = torch.ones(1, dtype=torch.int32, device=device)
        while bool(go.item()):
            trainer.train_loop(loader(n=tr["chunk"]), seed=run.seed)
            if rank == 0:
                go.fill_(int(time.perf_counter() - t0 < run.seconds))
            torch.distributed.broadcast(go, 0)
    t_end = time.perf_counter()
    if tracer is not None:
        run.trace = tracer.trace()
    run.attempted = steps - 3
    run.e2e["train_clips_per_s"] = (run.attempted * tr["clips_per_step"]
                                    / (t_end - t0))
    mine = _rank_summary(run.trace) if run.trace is not None else {
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if torch.cuda.is_available() else 0)}
    if world > 1:
        ranks = multihost.gather_to_coordinator(mine)
        del trainer
        free()
        torch.distributed.destroy_process_group()
    else:
        ranks = [mine]
        del trainer
        free()
    workdir.cleanup()
    if rank:
        return None
    run.memory_peak_bytes = max(r["memory_peak_bytes"] for r in ranks)
    run.counters["ranks"] = ranks
    return first


def run(run) -> None:
    """Rank 0 in this process; across chips, ranks 1.. in processes of
    their own (``python3 -m benchmark.drivers.train --rank r ...``),
    waited for before the comparison."""
    cfg, tr, world = run.config, run.traffic, run.chips
    port = _free_port() if world > 1 else 0
    spec = tempfile.NamedTemporaryFile("w", suffix=".json",
                                       prefix="sdvg-bench-")
    json.dump({"name": run.name, "cell": run.cell, "config": cfg,
               "traffic": tr, "seed": run.seed, "seconds": run.seconds,
               "traced": run.traced, "device": run.device}, spec)
    spec.flush()
    workers = [subprocess.Popen(
        WORKER + ["--spec", spec.name, "--rank", str(r), "--world",
                  str(world), "--port", str(port)])
        for r in range(1, world)]
    try:
        first = train(run, 0, world, port)
    finally:
        for w in workers:
            try:
                w.wait(timeout=120)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
    spec.close()
    if any(w.returncode for w in workers):
        raise RuntimeError(f"a rank failed: {[w.returncode for w in workers]}")
    if run.traced:
        run.work = step_work(cfg, tr)
    b1 = cfg["optimizer"]["b1"]
    prog = {"losses": first["losses"], "p0": first["p0"], "p3": first["p3"],
            "g1": {k: v.float() / (1 - b1) for k, v in first["mu1"].items()}}
    numbers, readings = compare(cfg, run.seed, run.device,
                                TR.train_batches(tr, run.seed), prog, world)
    print("readings " + json.dumps(readings), file=sys.stderr)
    for name, value in numbers.items():
        run.check(name, value, run.cell["limits"][name])


def main(argv=None) -> int:
    """A rank other than 0 of a run across chips, on rank 0's run
    (``--spec``, the JSON rank 0 wrote)."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--spec", required=True)
    for flag in ("--rank", "--world", "--port"):
        parser.add_argument(flag, type=int, required=True)
    args = parser.parse_args(argv)
    with open(args.spec) as f:
        d = json.load(f)
    run = harness.Run(d["name"], d["cell"], d["config"], d["traffic"],
                      d["seed"], d["seconds"], d["traced"],
                      time.perf_counter(), d["device"])
    train(run, args.rank, args.world, args.port)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: rank {args.rank} holds {found} after the window",
              file=sys.stderr)
        return 4
    return 0


def step_work(cfg: dict, tr: dict) -> roofline.Work:
    """The useful work of one step (forward and backward, no dropout),
    counted on the reference on the meta device."""
    model = roofline.meta_module(FrameTransformer,
                                 model_config(cfg, tr["frame_size"]))
    frames = torch.zeros(tr["clips_per_step"], tr["clip_frames"],
                         tr["frame_size"], tr["frame_size"], 3,
                         dtype=torch.uint8, device="meta")

    def step():
        out = P.train_loss(model, frames, cfg["frames_to_predict"], None,
                           cfg["losses"]["lambda_gdl"],
                           cfg["losses"]["lambda_contrastive"])
        out["total"].backward()
    return roofline.count(step)


def reference_steps(cfg: dict, seed: int, device, batches, n: int = 3,
                    ranks: int = 1, exchange: bool = True,
                    by_clip: bool = False, storage=None) -> dict:
    """The plain reference through ``n`` steps: ``losses`` a step, the
    first step's gradients ``g1``, the weights before ``p0`` and after
    ``p3``, all on ``device``. With ``ranks``, each step's batch is cut
    into that many slices with a dropout generator each, as the data ranks
    of the measured run draw, and the losses and gradients are the slices'
    means; without ``exchange``, rank 0's slice alone (a step whose
    all-reduce is left out, as rank 0 sees it). With ``by_clip``, also
    ``coherence``: leaf -> |mean_i g_i|^2 / mean_i |g_i|^2 over the first
    batch's clips' own gradients g_i at the first step's weights, near 1
    where every clip pulls a leaf the same way. ``storage``: the dtype the
    parameters and Adam's moments are kept in, in place of the
    configuration's (the weights are rounded to it before the first
    step)."""
    storage = storage or DTYPES[cfg["precision"]]
    with torch.device(device):
        model = FrameTransformer(model_config(cfg, batches[0].shape[2]))
    weights.load(model, weights.seeded(weights.shapes_of(model), seed,
                                       "transformer", device,
                                       DTYPES[cfg["precision"]],
                                       cfg.get("init_spread")))
    model.train()
    params = dict(model.named_parameters())
    adam = P.Adam(cfg["lr"], storage)
    with torch.no_grad():
        for v in params.values():
            v.copy_(adam._store(v))
    out = {"p0": {k: v.detach().clone() for k, v in params.items()},
           "losses": []}
    state = adam.init(params)
    loss_cfg = cfg["losses"]

    def loss(frames, gen):
        return P.train_loss(model, frames, cfg["frames_to_predict"], gen,
                            loss_cfg["lambda_gdl"],
                            loss_cfg["lambda_contrastive"])
    for s in range(n):
        frames = torch.as_tensor(batches[s]).to(device)
        per = frames.shape[0] // ranks
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        step = dict.fromkeys(LOSSES, 0.0)
        for r in range(ranks if exchange else 1):
            gen = torch.Generator(device=device)
            gen.manual_seed(P.dropout_seed(seed, s, r))
            got = loss(frames[r * per:(r + 1) * per], gen)
            share = 1 / ranks if exchange else 1.0
            for k, g in zip(params, torch.autograd.grad(
                    got["total"], list(params.values()))):
                grads[k] += g * share
            for k in LOSSES:
                step[k] += float(got[k].detach()) * share
        out["losses"].append(step)
        if s == 0:
            out["g1"] = {k: g.detach().clone() for k, g in grads.items()}
            if by_clip:
                out["coherence"] = _coherence(params, loss, frames, seed)
        adam.update(params, grads, state)
    out["p3"] = {k: v.detach() for k, v in params.items()}
    return out


def _coherence(params: dict, loss, frames, seed: int) -> dict:
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    square = dict.fromkeys(params, 0.0)
    for i in range(frames.shape[0]):
        gen = torch.Generator(device=frames.device)
        gen.manual_seed(P.dropout_seed(seed, -1, i))
        got = torch.autograd.grad(loss(frames[i:i + 1], gen)["total"],
                                  list(params.values()))
        for k, g in zip(params, got):
            total[k] += g
            square[k] += float(g.float().square().sum())
    n = frames.shape[0]
    return {k: float((total[k] / n).float().square().sum())
            / max(square[k] / n, 1e-30) for k in params}


def norm_gaps(prog: dict, ref: dict, keep) -> dict:
    """leaf -> the gap between the program's and the reference's norms of
    that leaf, over the reference's norm of it or of the median leaf,
    whichever is larger."""
    nr = {k: float(ref[k].float().norm()) for k in keep}
    med = statistics.median(nr.values())
    return {k: abs(float(prog[k].float().norm()) - nr[k])
            / max(nr[k], med, 1e-30) for k in keep}


def compare(cfg, seed, device, batches, prog: dict, ranks: int = 1):
    """The numbers for ``prog`` (its first three steps' loss components
    ``losses``, first gradient ``g1``, weights before step 1 and after
    step 3 ``p0``, ``p3``), and the readings they were chosen over."""
    ref = reference_steps(cfg, seed, device, batches, ranks=ranks,
                          by_clip=True)
    rel = [{k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in LOSSES} for got, want in zip(prog["losses"],
                                                  ref["losses"])]
    g_ref = {k: v.cpu() for k, v in ref["g1"].items()}
    g_norms = {k: float(v.norm()) for k, v in g_ref.items()}
    med = statistics.median(g_norms.values())
    moved = [k for k, n in g_norms.items() if n >= 1e-3 * med]
    g_gaps = norm_gaps(prog["g1"], g_ref, moved)
    coh = ref["coherence"]
    by_clip = sorted(moved, key=coh.get)[:max(1, len(moved) // 10)]
    prog_d = {k: prog["p3"][k].float() - prog["p0"][k].float()
              for k in moved}
    ref_d = {k: (ref["p3"][k] - ref["p0"][k]).cpu() for k in moved}
    d_gaps = norm_gaps(prog_d, ref_d, moved)
    worst_g = max(g_gaps, key=g_gaps.get)
    worst_d = max(d_gaps, key=d_gaps.get)
    numbers = {"loss1_rel": max(rel[0].values()),
               "loss_rel_3_steps": max(max(r.values()) for r in rel),
               "grad1_gap_clip_leaves": statistics.median(
                   g_gaps[k] for k in by_clip),
               "update_norm_gap": d_gaps[worst_d]}
    readings = {"loss1_by_component": rel[0],
                "grad_norm_gap_median": statistics.median(g_gaps.values()),
                "grad_norm_gap_worst": g_gaps[worst_g],
                "grad_worst_leaf": worst_g,
                "update_norm_gap_median": statistics.median(d_gaps.values()),
                "update_worst_leaf": worst_d,
                "clip_leaves": by_clip}
    return numbers, readings


if __name__ == "__main__":
    sys.exit(main())
