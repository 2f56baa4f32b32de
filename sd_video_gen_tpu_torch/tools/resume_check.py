"""Does a run resumed in a fresh process take the step an uninterrupted run
takes? ``train_ref_artifact``'s Trainer (the SD VAE in f32 encoding every
batch inside the step, its convolutions autotuned by cuDNN in each process,
``train/trainer.autotuned_convolutions``):

  1. a process takes one step, saves the checkpoint, takes a second step
     (the uninterrupted run) and saves that state;
  2. two fresh processes each restore the checkpoint and take the second
     step on the same batch and seed;
  3. the three states after the second step are compared bit for bit
     (parameters and both moments), and the largest difference of each
     tree is reported where they differ.

    python -m sd_video_gen_tpu_torch.tools.resume_check [--batch 64]
        [--workdir DIR] [--device cpu]

prints one JSON line: ``{"equal": {...}, "max_abs_diff": {...}, ...}``.
The steps are the compiled ones (``Trainer``'s step on the card). Needs the
card unless ``--device cpu`` (the same Trainer on the host, which the tests
run at a small ``--batch`` and ``--frame``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from sd_video_gen_tpu_torch.config import strict_f32
from sd_video_gen_tpu_torch.tools.bench_harness import (TRAIN_PATHS,
                                                        make_trainer,
                                                        train_frames)

PATH = next(p for p in TRAIN_PATHS if p["name"] == "train_ref_artifact")
TREES = ("params", "mu", "nu")


def _path(batch: int, frame: int | None) -> dict:
    cfg = PATH["cfg"].replace(batch_size=batch)
    if frame is not None:
        cfg = cfg.replace(frame_size=frame)
    return dict(PATH, cfg=cfg)


def _state(trainer) -> dict:
    sd = trainer.state.state_dict()
    return {"step": sd["step"], **{t: {k: v.detach().cpu().clone()
                                       for k, v in sd[t].items()}
                                   for t in TREES}}


def child(role: str, workdir: str, batch: int, frame: int | None,
          device: str) -> None:
    """``role`` 'first': step 1, save, step 2 (kept as ``uninterrupted``);
    'resumed_<i>': restore the checkpoint, step 2 (kept under the role)."""
    strict_f32()
    path = _path(batch, frame)
    trainer = make_trainer(path, workdir, seed=0, device=device)
    frames = [train_frames(path, seed=s) for s in (1, 2)]
    t0 = time.perf_counter()
    if role == "first":
        trainer._step_fn(trainer.state, frames[0], 0)
        name = os.path.basename(trainer.save("resume"))
        with open(os.path.join(workdir, "checkpoint_name"), "w") as f:
            f.write(name)
        out = "uninterrupted"
    else:
        with open(os.path.join(workdir, "checkpoint_name")) as f:
            trainer.resume(f.read())
        out = role
    trainer._step_fn(trainer.state, frames[1], 0)
    state = _state(trainer)
    state["seconds"] = time.perf_counter() - t0
    torch.save(state, os.path.join(workdir, out + ".pt"))


def compare(states: dict) -> dict:
    """Each state against the uninterrupted run's, tree by tree."""
    ref = states["uninterrupted"]
    equal, diff = {}, {}
    for name, st in states.items():
        if name == "uninterrupted":
            continue
        equal[name] = st["step"] == ref["step"] and all(
            torch.equal(v, ref[t][k]) for t in TREES
            for k, v in st[t].items())
        diff[name] = {t: max(float((v.double() - ref[t][k].double()).abs()
                                   .max()) for k, v in st[t].items())
                      for t in TREES}
    return {"equal": equal, "max_abs_diff": diff,
            "steps": ref["step"]}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=PATH["cfg"].batch_size)
    parser.add_argument("--frame", type=int, default=None,
                        help="frame size (default: the path's 128)")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child[0], args.child[1], args.batch, args.frame,
              args.device)
        return {}
    with tempfile.TemporaryDirectory(prefix="sdvg_resume") as tmp:
        workdir = args.workdir or tmp
        os.makedirs(workdir, exist_ok=True)
        t0 = time.perf_counter()
        for role in ("first", "resumed_1", "resumed_2"):
            cmd = [sys.executable, "-m", __spec__.name, "--batch",
                   str(args.batch), "--device", args.device, "--child",
                   role, workdir]
            if args.frame is not None:
                cmd += ["--frame", str(args.frame)]
            subprocess.run(cmd, check=True)
        states = {name: torch.load(os.path.join(workdir, name + ".pt"),
                                   weights_only=True)
                  for name in ("uninterrupted", "resumed_1", "resumed_2")}
        out = compare(states)
        out.update(batch=args.batch, device=(
            torch.cuda.get_device_name(0) if args.device != "cpu"
            else "cpu"), seconds=round(time.perf_counter() - t0, 3),
            child_seconds={k: round(v["seconds"], 3)
                           for k, v in states.items()})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
