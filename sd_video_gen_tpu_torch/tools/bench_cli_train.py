"""The product training CLI's rate against the benchmark's
``train_flagship`` (``tools/bench_cli_train.py`` beside the JAX package, on
the port's trainer CLI).

The benchmark times ``Trainer.train_loop`` on one fixed batch; this tool
runs the CLI a user runs, ``python -m sd_video_gen_tpu_torch.train.trainer``,
as a child process end to end: the C++ native-cache loader -> the batch's
copy to the card -> the step -> epoch metrics -> checkpoint, at the same
operating point (the flagship's widths, batch 6, 10-frame 128px clips,
``--precision bf16_full`` by default), and reads the step rate off the
trainer's own metrics JSONL (``step_ms_*`` from
``utils/profiling.StepTimer``).

The first epoch absorbs the start-up (its p95 is that step); the warm
epochs' ``step_ms_mean`` is the steady CLI rate. ``StepTimer`` clocks the
host's ``train.step`` span, from the batch's copy to the step's return and
its loss sums, without a synchronise: the host runs ahead of the card by
up to its launch queue, and the epoch's last steps drain inside the
untimed epoch-end metrics fetch. Read the result as
"the CLI adds nothing over the benchmark's rate" where the step is host-bound
(``train_flagship`` at batch 6 is), not as a device time.

Self-contained: the JAX tool's config ``cli_flag128`` (``EPOCHS`` from
``--epochs``), the clips as the JAX tool's bouncing-ball PNG tree (16 train
sequences of 30 frames: 48 clips, 8 batches of 6; written and read with
``cv2``) or, where ``cv2`` is missing, ``--dataset mnist``: a seeded
Moving-MNIST-layout ``.npy`` of as many clips (60 sequences of 10 frames,
one clip each, the last 20% the test split), and the native cache built
from them by ``python -m sd_video_gen_tpu_torch.data.native_loader``. The
trainer runs with its working directory in ``--workdir`` (its ``logs/``
land there) and the repository root on ``PYTHONPATH``.

    python -m sd_video_gen_tpu_torch.tools.bench_cli_train [--workdir DIR]
        [--epochs 4] [--precision f32|bf16|bf16_full]
        [--dataset ball|mnist] [--device cpu]

Prints one JSON line with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from sd_video_gen_tpu_torch.config import strict_f32, write_config
from sd_video_gen_tpu_torch.tools import counted as C
from sd_video_gen_tpu_torch.tools.bench_cli_serving import (REPO, card,
                                                            child_env,
                                                            device_argv)

LOADER = "sd_video_gen_tpu_torch.data.native_loader"
TRAINER = "sd_video_gen_tpu_torch.train.trainer"
CONFIG_NAME = "cli_flag128"
BATCH = 6
# The JAX tool's config: the flagship's widths (11_27_ucf_final.yml); 10-frame
# clips of 128px as the benchmark's train_flagship (5 context + 5 predicted).
CONFIG = {"LR": [1.0e-5], "BATCH_SIZE": [BATCH], "EPOCHS": [4],
          "EPOCH_RATIO": [1], "NUM_WORKERS": [4], "FRAMES_PER_CLIP": [10],
          "FRAMES_TO_PREDICT": [5], "STRIDE": [1], "FPS": [3],
          "FRAME_SIZE": 128, "DIM_MODEL": [2048], "NUM_HEADS": [8],
          "NUM_ENCODER_LAYERS": [4], "NUM_DECODER_LAYERS": [8],
          "DROPOUT_P": [0.1], "USE_MSE": [True], "USE_GDL": [True],
          "LAMBDA_GDL": [1], "ALPHA": [1], "USE_CONTRASTIVE": [True],
          "LAMBDA_CONTRASTIVE": [0.025]}


def prepare(workdir: str, epochs: int, dataset: str = "ball",
            config: dict = CONFIG) -> dict:
    """The config (``EPOCHS`` = ``epochs``) and the clips under ``workdir``
    (the clips kept where they exist); the paths the CLIs' flags name."""
    cfg_dir = os.path.join(workdir, "configs")
    os.makedirs(cfg_dir, exist_ok=True)
    write_config(os.path.join(cfg_dir, CONFIG_NAME + ".yml"),
                 dict(config, EPOCHS=[epochs]))
    size, frames = config["FRAME_SIZE"], config["FRAMES_PER_CLIP"][0]
    if dataset == "ball":
        folder = os.path.join(workdir, "ball")
        if not os.path.isdir(os.path.join(folder, "test")):
            from sd_video_gen_tpu_torch.data.synthetic import (
                generate_bouncing_ball_tree)
            # 16 train sequences of 30 frames: 48 ten-frame clips, 8
            # batches of 6
            generate_bouncing_ball_tree(folder, n_train_seqs=16,
                                        n_test_seqs=4, frames_per_seq=30,
                                        size=size)
    else:
        folder = os.path.join(workdir, "mnist.npy")
        if not os.path.isfile(folder):
            from sd_video_gen_tpu_torch.tools.quality_modes import (
                make_moving_disks)
            make_moving_disks(folder, seqs=60, frames=frames, size=size)
    return {"dataset": dataset, "folder": folder, "cfg_dir": cfg_dir,
            "cache": os.path.join(workdir, "cache"),
            "checkpoints": os.path.join(workdir, "checkpoints")}


def build_cache(paths: dict) -> None:
    """The native frame cache through the port's cache CLI (kept where it
    exists)."""
    if os.path.isfile(os.path.join(paths["cache"], "train.bin")):
        return
    cmd = C.command(LOADER, False) + [
        "--dataset", paths["dataset"], "--folder", paths["folder"],
        "--config", CONFIG_NAME, "--config_dir", paths["cfg_dir"], "--out",
        paths["cache"]]
    subprocess.run(cmd, cwd=REPO, env=child_env(), check=True,
                   capture_output=True, text=True)


def run_trainer(workdir: str, paths: dict, precision: str, timeout_s: float,
                device=None, extra_argv=(), counted: bool = False) -> dict:
    """One trainer CLI run from a fresh checkpoint directory: its wall
    seconds, its metrics log's rows (and ``launches``, the child's counts,
    when ``counted``)."""
    log = os.path.join(workdir, "logs", f"{CONFIG_NAME}_0.jsonl")
    if os.path.exists(log):
        os.unlink(log)
    # the trainer numbers runs <config>_<index> by counting existing
    # checkpoints, and the log path above assumes index 0
    shutil.rmtree(paths["checkpoints"], ignore_errors=True)
    cmd = C.command(TRAINER, counted) + [
        "--dataset", paths["dataset"], "--config", CONFIG_NAME,
        "--config_dir", paths["cfg_dir"], "--folder", paths["folder"],
        "--native_cache", paths["cache"], "--precision", precision,
        "--debug", "True", "--ckpt_every", "99", "--seed", "0",
        "--checkpoint_dir", paths["checkpoints"]]
    cmd += device_argv(device) + list(extra_argv)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=workdir, env=child_env(),
                          capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"trainer rc={proc.returncode}; stderr tail:\n"
                           + proc.stderr[-2000:])
    with open(log) as f:
        rows = [r for r in (json.loads(line) for line in f)
                if "step_ms_mean" in r]       # skip init / event rows
    out = {"wall_s": wall, "rows": rows}
    if counted:
        out["launches"] = C.parse(proc.stdout.splitlines())
    return out


def summarize(rows: list, precision: str, wall: float) -> dict:
    """The JAX tool's reduction of the metrics rows."""
    warm = rows[1:]
    if not warm:
        raise RuntimeError("need >=2 epochs in the metrics log")
    mean_ms = sum(r["step_ms_mean"] for r in warm) / len(warm)
    return {
        "metric": "cli_train_flagship_steps_per_sec",
        "steady_steps_per_s": round(1e3 / mean_ms, 2),
        "steady_clips_per_s": round(1e3 / mean_ms * BATCH, 1),
        "warm_epoch_step_ms": [round(r["step_ms_mean"], 2) for r in warm],
        "compile_epoch_p95_ms": round(rows[0]["step_ms_p95"], 1),
        "train_loss_first_last": [round(rows[0]["train_loss"], 3),
                                  round(rows[-1]["train_loss"], 3)],
        "precision": precision, "wall_s": round(wall, 1)}


def main(argv=None) -> int:
    strict_f32()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "sdvg_cli_train"))
    ap.add_argument("--epochs", type=int, default=4,
                    help="epoch 1 absorbs the start-up; >=3 warm epochs")
    ap.add_argument("--precision", default="bf16_full",
                    choices=["f32", "bf16", "bf16_full"])
    ap.add_argument("--timeout_s", type=float, default=1800)
    ap.add_argument("--dataset", default="ball", choices=["ball", "mnist"],
                    help="ball: the JAX tool's PNG tree (cv2); mnist: a "
                         "Moving-MNIST-layout .npy (numpy only)")
    ap.add_argument("--device", default=None,
                    help="the trainer's --device (default: the card)")
    args = ap.parse_args(argv)
    if args.epochs < 2:
        ap.error("--epochs must be >=2 (epoch 1 is the start-up epoch)")
    paths = prepare(args.workdir, args.epochs, args.dataset)
    build_cache(paths)
    run = run_trainer(args.workdir, paths, args.precision, args.timeout_s,
                      device=args.device)
    print(json.dumps(dict(
        summarize(run["rows"], args.precision, run["wall_s"]),
        card=card(args.device),
        note="steady = warm-epoch step_ms_mean from the trainer's own "
             "metrics JSONL; comparable to the port's benchmark scenario "
             "train_flagship")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
