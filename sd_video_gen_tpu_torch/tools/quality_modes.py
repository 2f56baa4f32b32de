"""Learning evidence for the training modes: each trained model against the
Identity copy baseline (``tools/quality_modes.py`` beside the JAX package,
on the port's entry points).

The reference's own quality control is the Identity baseline ("predict next
frame = last frame"): a trained model must beat it on FVD and on pixel MSE.
For each mode of ``--modes``:

  train on synthetic data through the port's trainer CLI (``train.trainer``)
  score trained and Identity (``--naive True``) with the port's FVD CLI
  (``evaluation.predict_fvd``), the same protocol for both arms

Both CLIs run in this process (``main(argv)`` under ``contextlib.chdir``
into the mode's directory, their output appended to its ``run.log``), so a
caller that counts kernel launches sees every launch; the scores are the
``(fvd, mse)`` that ``predict_fvd.main`` returns.

Data, as in the JAX tool: ``ar`` / ``diff`` / ``future`` train on the
bouncing-ball PNG tree (``generate_bouncing_ball_tree(ball, 24, 6, 30,
64)``); ``text`` trains on a two-class UCF-format ``.avi`` tree whose classes
move in OPPOSITE horizontal directions (SlideLeft / SlideRight), so the
class name carries signal. One departure, for a machine without ``cv2``
(which writes and reads the PNG tree and the ``.avi`` files):
``--dataset mnist`` writes a seeded Moving-MNIST-layout ``.npy`` of the
same scale instead (30 sequences of 30 frames at 64px, bright disks moving
and bouncing, drawn with numpy) and passes ``--dataset mnist --folder
<npy>`` to both CLIs. ``text`` needs the ``.avi`` tree whatever
``--dataset`` says: where ``cv2`` is missing it raises, naming ``cv2``.

FVD uses the random-init I3D (self-consistent: the same featurizer for both
arms; not comparable to published FVDs). A mode passes when trained FVD <
naive FVD AND trained MSE < naive MSE.

    python -m sd_video_gen_tpu_torch.tools.quality_modes [--scratch DIR]
        [--epochs 20] [--modes ar,diff,future,text] [--skip_train]
        [--dataset ball|mnist] [--device cpu]

Prints a markdown table, merges the results into
``<scratch>/quality_modes.json`` and exits 1 if any mode fails its gate.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

from sd_video_gen_tpu_torch.config import strict_f32, write_config

# The JAX tool's config (lr 3e-4, batch 8, 5 + 5 frames at stride 2, 64px,
# dim 1024, 8 heads, 2 enc + 4 dec, dropout 0.1, MSE + GDL), with EPOCHS
# from --epochs. Written as JSON, which PyYAML reads too.
BALL_CFG = {"LR": [3.0e-4], "BATCH_SIZE": [8], "EPOCHS": [20],
            "EPOCH_RATIO": [1], "NUM_WORKERS": [0], "FRAMES_PER_CLIP": [5],
            "FRAMES_TO_PREDICT": [5], "STRIDE": [2], "FPS": [12],
            "FRAME_SIZE": 64, "DIM_MODEL": [1024], "NUM_HEADS": [8],
            "NUM_ENCODER_LAYERS": [2], "NUM_DECODER_LAYERS": [4],
            "DROPOUT_P": [0.1], "USE_MSE": [True], "USE_GDL": [True],
            "LAMBDA_GDL": [True], "ALPHA": [2]}
CONFIG = "q5"
# The --dataset mnist stand-in: sequences, frames, frame size.
MNIST_SHAPE = (30, 30, 64)


def make_ucf_tree(root: str, frame_size: int = 64) -> tuple[str, str]:
    """Two-class UCF-format .avi tree with class-dependent motion.

    SlideLeft / SlideRight: a bright square slides horizontally, direction
    set by the class; 8 videos of 24 frames a class, 6 of them in the train
    list. The bytes are those the JAX tool writes.
    """
    import cv2
    data = os.path.join(root, "UCF-101")
    splits = os.path.join(root, "splits")
    os.makedirs(splits, exist_ok=True)
    rng = np.random.default_rng(0)
    names: dict[str, list[str]] = {}
    for cls, vx in (("SlideLeft", -3), ("SlideRight", 3)):
        os.makedirs(os.path.join(data, cls), exist_ok=True)
        for vi in range(8):
            name = f"v_{cls}_g{vi:02d}_c01.avi"
            vw = cv2.VideoWriter(os.path.join(data, cls, name),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                                 (frame_size, frame_size))
            x = int(rng.integers(16, frame_size - 16))
            y = int(rng.integers(8, frame_size - 16))
            shade = int(rng.integers(160, 250))
            for _ in range(24):
                frame = np.zeros((frame_size, frame_size, 3), np.uint8)
                x = (x + vx) % frame_size
                frame[y:y + 10, x:min(x + 10, frame_size)] = shade
                vw.write(frame)
            vw.release()
            names.setdefault(cls, []).append(f"{cls}/{name}")
    with open(os.path.join(splits, "trainlist01.txt"), "w") as f:
        for vs in names.values():
            for v in vs[:6]:
                f.write(f"{v} 1\n")
    with open(os.path.join(splits, "testlist01.txt"), "w") as f:
        for vs in names.values():
            for v in vs[6:]:
                f.write(f"{v}\n")
    return data, splits


def make_moving_disks(path: str, seqs: int = MNIST_SHAPE[0],
                      frames: int = MNIST_SHAPE[1], size: int = MNIST_SHAPE[2],
                      seed: int = 0) -> str:
    """A Moving-MNIST-layout (frames, seqs, size, size) uint8 ``.npy``: in
    each sequence one bright disk moves at a constant seeded velocity and
    bounces off the borders (the ball tree's motion, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    radius = max(3, size // 8)
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((frames, seqs, size, size), np.uint8)
    for n in range(seqs):
        pos = rng.uniform(radius, size - radius, 2)
        vel = rng.uniform(-size / 8, size / 8, 2)
        shade = int(rng.integers(100, 256))
        for t in range(frames):
            for ax in range(2):
                if pos[ax] - radius < 0 or pos[ax] + radius > size:
                    vel[ax] = -vel[ax]
                    pos[ax] = np.clip(pos[ax], radius, size - radius)
            disk = (xx - pos[0]) ** 2 + (yy - pos[1]) ** 2 <= radius ** 2
            out[t, n][disk] = shade
            pos += vel
    np.save(path, out)
    return path


_RESULT_RE = re.compile(
    r"FVD \((?:streaming|batch), (\d+) clips\): ([0-9.]+)\s+pred MSE: "
    r"([0-9.eE+-]+)")


def parse_result(log_path: str):
    """(clips, FVD, MSE) of the last result line the FVD CLI wrote to
    ``log_path``."""
    m = None
    with open(log_path) as f:
        for m in _RESULT_RE.finditer(f.read()):
            pass
    if m is None:
        raise RuntimeError(f"no FVD result line in {log_path}")
    return int(m.group(1)), float(m.group(2)), float(m.group(3))


def _require_cv2(what: str) -> None:
    if importlib.util.find_spec("cv2") is None:
        raise RuntimeError(f"{what} needs cv2 (OpenCV), which is not "
                           f"installed: use --dataset mnist, and leave "
                           f"'text' out of --modes")


def _in(workdir: str, log_path: str, main, argv):
    """``main(argv)`` run in ``workdir`` with its output appended to
    ``log_path``; (its return value, seconds)."""
    t0 = time.perf_counter()
    with open(log_path, "a") as log, contextlib.chdir(workdir):
        log.write(f"\n$ {main.__module__} {' '.join(argv)}\n")
        log.flush()
        with contextlib.redirect_stdout(log):
            out = main(argv)
    return out, time.perf_counter() - t0


def gate(entry: dict) -> bool:
    """A mode passes when the trained model beats Identity on both FVD and
    MSE."""
    return (entry["trained"]["fvd"] < entry["naive"]["fvd"]
            and entry["trained"]["mse"] < entry["naive"]["mse"])


def table(results: dict) -> str:
    lines = ["| mode | FVD trained | FVD naive | MSE trained | MSE naive "
             "| beats Identity |", "|---|---|---|---|---|---|"]
    for mode, e in results.items():
        lines.append(f"| {mode} | {e['trained']['fvd']:.3f} "
                     f"| {e['naive']['fvd']:.3f} | {e['trained']['mse']:.5f} "
                     f"| {e['naive']['mse']:.5f} "
                     f"| {'YES' if e['pass'] else 'NO'} |")
    return "\n".join(lines)


def frames_flags(scratch: str, dataset: str) -> list:
    """The CLI flags of the data the frame modes train on under
    ``scratch``."""
    if dataset == "ball":
        return ["--dataset", "ball", "--folder", os.path.join(scratch, "ball")]
    return ["--dataset", "mnist", "--folder",
            os.path.join(scratch, "mnist.npy")]


def data_args(args) -> dict:
    """The data each kind of mode trains on, made under ``--scratch`` where
    it is not there yet: ``{"frames": [...], "text": [...]}`` CLI flags."""
    out = {}
    if set(args.modes) - {"text"}:
        out["frames"] = frames_flags(args.scratch, args.dataset)
        folder = out["frames"][-1]
        if args.dataset == "ball":
            from sd_video_gen_tpu_torch.data import generate_bouncing_ball_tree
            if not os.path.isdir(os.path.join(folder, "train")):
                _require_cv2("--dataset ball (a PNG tree)")
                generate_bouncing_ball_tree(folder, 24, 6, 30, 64)
        elif not os.path.exists(folder):
            make_moving_disks(folder)
    if "text" in args.modes:
        _require_cv2("the text mode (a UCF-format .avi tree)")
        root = os.path.join(args.scratch, "ucf")
        data = os.path.join(root, "UCF-101")
        splits = os.path.join(root, "splits")
        if not os.path.isdir(data):
            data, splits = make_ucf_tree(root)
        out["text"] = ["--dataset", "ucf", "--folder", data,
                       "--ucf_labels", splits]
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scratch",
                    default=os.path.join(tempfile.gettempdir(), "qual5"))
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--modes", default="ar,diff,future,text")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse checkpoints from a previous run")
    ap.add_argument("--max_clips", type=int, default=14)
    ap.add_argument("--batch_clips", type=int, default=7)
    ap.add_argument("--dataset", default="ball", choices=("ball", "mnist"),
                    help="ball: the JAX tool's PNG tree (needs cv2); mnist: "
                         "a Moving-MNIST-layout .npy of the same scale")
    ap.add_argument("--device", default=None,
                    help="torch device of both CLIs (default: the card)")
    return ap


def main(argv=None) -> int:
    strict_f32()
    from sd_video_gen_tpu_torch.evaluation import predict_fvd
    from sd_video_gen_tpu_torch.train import trainer
    args = build_parser().parse_args(argv)
    args.modes = args.modes.split(",")
    args.scratch = os.path.abspath(args.scratch)
    os.makedirs(args.scratch, exist_ok=True)
    data = data_args(args)
    device = ["--device", args.device] if args.device else []

    results = {}
    for mode in args.modes:
        wd = os.path.join(args.scratch, mode)
        os.makedirs(os.path.join(wd, "configs"), exist_ok=True)
        write_config(os.path.join(wd, "configs", CONFIG + ".yml"),
                     dict(BALL_CFG, EPOCHS=[args.epochs]))
        log = os.path.join(wd, "run.log")
        common = data["text" if mode == "text" else "frames"] + [
            "--config", CONFIG, "--config_dir", "configs", "--train_mode",
            mode, "--debug", "True", "--seed", "0", *device]
        seconds = 0.0
        if not args.skip_train:
            _, dt = _in(wd, log, trainer.main,
                        common + ["--ckpt_every", "1000"])
            seconds += dt
            print(f"[{mode}] trained {args.epochs} epochs in {dt:.1f}s",
                  flush=True)
        entry = {}
        for arm, extra in (("trained", []), ("naive", ["--naive", "True"])):
            (fvd, mse), dt = _in(wd, log, predict_fvd.main, common + extra + [
                "--pred_frames", "4", "--max_clips", str(args.max_clips),
                "--batch_clips", str(args.batch_clips)])
            seconds += dt
            n, _, _ = parse_result(log)
            entry[arm] = {"clips": n, "fvd": fvd, "mse": mse}
            print(f"[{mode}] {arm}: FVD {fvd:.3f}  MSE {mse:.5f} ({n} clips)",
                  flush=True)
        entry["pass"] = gate(entry)
        entry["seconds"] = round(seconds, 1)
        results[mode] = entry

    print("\n" + table(results))
    out = os.path.join(args.scratch, "quality_modes.json")
    merged = {}
    if os.path.exists(out):  # partial runs per --modes accumulate
        with open(out) as f:
            merged = json.load(f)
    merged.update(results)
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"\nwrote {out}")
    return 0 if all(e["pass"] for e in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
