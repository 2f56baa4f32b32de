"""The product CLI's serving rate on the north-star denoise pipeline
(``tools/bench_cli_serving.py`` beside the JAX package, on the port's
``predict`` CLI).

The benchmark's ``vae_denoise_ar4_8streams`` times the pipeline body alone;
this tool runs the CLI a user runs, ``python -m
sd_video_gen_tpu_torch.predict.predict``, as a child process end to end:
dataset fetch -> VAE encode -> AR rollout with the 10-step DDIM refine at
512px -> VAE decode -> optional PNG writes, and reads generated frames/s off
the CLI's own ``--timing`` line.

Batch mode (default): ONE CLI run over ``--n_batches`` batches of
``--streams`` clips. The ``--timing`` line's ``first_sync_s`` is when the
first batch's rollout ended (a CUDA event on the card), so

    steady_fps = (clips - streams) * pred_frames / (total_s - first_sync_s)

is the warm rate over batches 2..N, comparable to the benchmark's scenario.
Batch 2 overlaps the first sync point (the CLI's loop is pipelined one batch
deep), so the steady rate includes that overlap by design.

Serve mode (``--mode serve``): one ``predict --serve SOCK`` process; once it
prints ``SERVE_READY`` (its one warm-up batch done), ``--n_requests``
requests go through the port's socket client (``predict/serve.request``):
request 1's latency is a warm server's time to first frame.

Self-contained: the JAX tool's flagship-width config ``cli_flagship``
(dim 2048, 4 + 8 layers on 256-d VAE latents of 64px frames, 5 context + 4
predicted frames), a seeded FrameTransformer checkpoint in the port's
trainer format (``train/checkpoint.py``; weights do not change the rate),
and the clips: the JAX tool's bouncing-ball PNG tree (``--dataset ball``,
written and read with ``cv2``), or, where ``cv2`` is missing,
``--dataset mnist``: a seeded Moving-MNIST-layout ``.npy`` holding the same
number of test clips (bright disks drawn with numpy). The SD VAE, UNet and
CLIP text encoder are the CLI's seeded SD-v1.4 weights (no weight flags).

    python -m sd_video_gen_tpu_torch.tools.bench_cli_serving [--workdir DIR]
        [--streams 8] [--n_batches 8] [--sampler ddim|dpmpp]
        [--solver_steps N] [--mode batch|serve] [--n_requests 6]
        [--dataset ball|mnist] [--device cpu]

Prints one JSON line with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from sd_video_gen_tpu_torch.config import load_config, strict_f32, write_config
from sd_video_gen_tpu_torch.tools import counted as C

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREDICT = "sd_video_gen_tpu_torch.predict.predict"
CONFIG_NAME = "cli_flagship"
# The JAX tool's config: the flagship's widths (11_27_ucf_final.yml) at the
# benchmark's 64px serving shape.
CONFIG = {"LR": [1.0e-5], "BATCH_SIZE": [6], "EPOCHS": [1],
          "EPOCH_RATIO": [1], "NUM_WORKERS": [0], "FRAMES_PER_CLIP": [5],
          "FRAMES_TO_PREDICT": [4], "STRIDE": [1], "FPS": [3],
          "FRAME_SIZE": 64, "DIM_MODEL": [2048], "NUM_HEADS": [8],
          "NUM_ENCODER_LAYERS": [4], "NUM_DECODER_LAYERS": [8],
          "DROPOUT_P": [0.1], "USE_MSE": [True], "USE_GDL": [True],
          "LAMBDA_GDL": [1], "ALPHA": [1], "USE_CONTRASTIVE": [True],
          "LAMBDA_CONTRASTIVE": [0.025]}


def count_test_clips(dataset: str, folder: str, cfg) -> int:
    """Test clips the CLI's dataset yields (``train.trainer.build_dataset``
    for mode ``ar``)."""
    from sd_video_gen_tpu_torch.data import (BouncingBallDataset,
                                             MovingMNISTDataset)
    if dataset == "ball":
        return len(BouncingBallDataset(num_frames=cfg.frames_per_clip,
                                       stride=cfg.stride, dir=folder,
                                       stage="test", seed=0))
    return len(MovingMNISTDataset(cfg.frames_per_clip, cfg.stride, folder,
                                  "test", seed=0))


def prepare(workdir: str, need_clips: int, dataset: str = "ball",
            device=None, config: dict = CONFIG) -> dict:
    """The clips, the config and a seeded checkpoint under ``workdir``
    (each kept where it exists); the paths the CLI's flags name."""
    import torch
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models.transformer import (
        FrameTransformer, FrameTransformerConfig)
    from sd_video_gen_tpu_torch.train.checkpoint import (checkpoint_path,
                                                         save_checkpoint)
    from sd_video_gen_tpu_torch.train.optim import Adam
    from sd_video_gen_tpu_torch.train.trainer import TrainState

    cfg_dir = os.path.join(workdir, "configs")
    ckpt_dir = os.path.join(workdir, "checkpoints")
    os.makedirs(cfg_dir, exist_ok=True)
    write_config(os.path.join(cfg_dir, CONFIG_NAME + ".yml"), config)
    cfg = load_config(CONFIG_NAME, cfg_dir)
    if dataset == "ball":
        folder = os.path.join(workdir, "ball")
        if not os.path.isdir(os.path.join(folder, "test")):
            from sd_video_gen_tpu_torch.data.synthetic import (
                generate_bouncing_ball_tree)
            # clips step without overlap, so 35-frame sequences hold 7
            # five-frame clips each
            generate_bouncing_ball_tree(
                folder, n_train_seqs=1, n_test_seqs=max(2, (need_clips + 6)
                                                        // 7),
                frames_per_seq=35, size=cfg.frame_size)
    else:
        # one clip a sequence, and the last 20% of the sequences are the
        # test split
        folder = os.path.join(workdir, f"mnist_{need_clips}.npy")
        if not os.path.isfile(folder):
            from sd_video_gen_tpu_torch.tools.quality_modes import (
                make_moving_disks)
            make_moving_disks(folder, seqs=5 * need_clips,
                              frames=cfg.frames_per_clip,
                              size=cfg.frame_size)
    have = count_test_clips(dataset, folder, cfg)
    if have < need_clips:
        raise RuntimeError(f"the {dataset} data yields {have} test clips; "
                           f"{need_clips} are needed")
    path = checkpoint_path(ckpt_dir, CONFIG_NAME, 0, "test")
    if not os.path.isdir(path):
        model = build(FrameTransformer, FrameTransformerConfig.from_config(
            cfg), device, seed=0)
        params = dict(model.named_parameters())
        save_checkpoint(path, TrainState(model, Adam(cfg.lr).init(params))
                        .state_dict())
        del model, params
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    return {"dataset": dataset, "folder": folder, "cfg_dir": cfg_dir,
            "ckpt_dir": ckpt_dir}


def cli_argv(paths: dict, streams: int, pred: int, sampler: str,
             solver_steps: int | None, counted: bool, middle=(),
             end=()) -> list:
    """The child's command line, the JAX tool's flags in its order with the
    port's module (through ``tools/counted`` when ``counted``): the mode's
    ``middle`` flags before the sampler's, its ``end`` flags after."""
    return C.command(PREDICT, counted) + [
        "--dataset", paths["dataset"], "--folder", paths["folder"],
        "--config", CONFIG_NAME, "--config_dir", paths["cfg_dir"],
        "--checkpoint_dir", paths["ckpt_dir"], "--index", "0",
        "--codec", "vae", "--denoise", "True",
        "--denoise_start_step", "40", "--pred_frames", str(pred),
        "--batch_clips", str(streams), *middle, "--seed", "0",
        "--denoise_sampler", sampler, *end] + (
        ["--denoise_solver_steps", str(solver_steps)]
        if solver_steps is not None else [])


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def device_argv(device) -> list:
    return ["--device", str(device)] if device else []


def run_cli(paths: dict, max_clips: int, streams: int, pred: int,
            save_output: bool, timeout_s: float, sampler: str = "ddim",
            solver_steps: int | None = None, device=None, extra_argv=(),
            counted: bool = False) -> dict:
    """One batch-mode CLI run: its ``--timing`` payload with ``wall_s`` (and
    ``launches``, the child's counts, when ``counted``)."""
    cmd = cli_argv(paths, streams, pred, sampler, solver_steps, counted,
                   middle=["--max_clips", str(max_clips), "--save_output",
                           str(save_output), "--timing"])
    cmd += device_argv(device) + list(extra_argv)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=child_env(), capture_output=True,
                          text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"CLI rc={proc.returncode}; stderr tail:\n"
                           + proc.stderr[-2000:])
    lines = proc.stdout.splitlines()
    timing = None
    for line in lines:
        if line.startswith("{"):
            timing = json.loads(line)
    if timing is None:
        raise RuntimeError("no --timing JSON in CLI stdout:\n"
                           + proc.stdout[-2000:])
    timing["wall_s"] = round(wall, 3)
    if counted:
        timing["launches"] = C.parse(lines)
    return timing


def run_serve_bench(paths: dict, streams: int, pred: int, n_requests: int,
                    timeout_s: float, sampler: str = "ddim",
                    solver_steps: int | None = None, device=None,
                    extra_argv=(), counted: bool = False) -> dict:
    """The persistent server (``predict --serve``): start it, wait for
    ``SERVE_READY`` (its warm-up batch done), time ``n_requests`` requests
    over the socket, shut it down."""
    from sd_video_gen_tpu_torch.predict import serve as S

    cfg = load_config(CONFIG_NAME, paths["cfg_dir"])
    sock = os.path.join(paths["cfg_dir"], "..", "serve.sock")
    cmd = cli_argv(paths, streams, pred, sampler, solver_steps, counted,
                   end=["--serve", sock]) + device_argv(device) + list(
        extra_argv)
    t_launch = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=child_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, ready = [], queue.Queue()

    def read():                      # every line, READY handed over
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("SERVE_READY"):
                ready.put(line)
        ready.put(None)              # the child closed its output

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        try:
            ready_line = ready.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError("server never printed SERVE_READY") from None
        if ready_line is None:
            raise RuntimeError(f"server exited rc={proc.wait()} before "
                               f"READY:\n" + "\n".join(lines[-40:]))
        ready_wall = time.perf_counter() - t_launch
        ready_info = json.loads(ready_line.split(" ", 1)[1])

        rng = np.random.default_rng(0)
        frames = rng.integers(0, 255, (streams, cfg.frames_per_clip,
                                       cfg.frame_size, cfg.frame_size,
                                       3)).astype(np.uint8)
        latencies = []
        for _ in range(n_requests):
            t0 = time.perf_counter()
            imgs, is_pred, _ = S.request(sock, frames, timeout_s=timeout_s)
            latencies.append(time.perf_counter() - t0)
            if sum(is_pred) != pred or imgs.shape[0] != streams:
                raise RuntimeError(f"reply of {imgs.shape[0]} clips with "
                                   f"{sum(is_pred)} predicted frames")
        S.shutdown(sock)
        rc = proc.wait(timeout=60)
        reader.join(timeout=60)
        if rc != 0:
            raise RuntimeError(f"server rc={rc}:\n" + "\n".join(lines[-40:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    steady = sorted(latencies[1:])[len(latencies[1:]) // 2]
    out = {
        "server_ready_wall_s": round(ready_wall, 2),
        "server_warmup_s": ready_info["ready_s"],
        "ttff_warm_server_s": round(latencies[0], 3),
        "steady_request_s_median": round(steady, 3),
        "steady_fps": round(streams * pred / steady, 2),
        "request_latencies_s": [round(x, 3) for x in latencies],
        "n_requests": n_requests}
    if counted:
        out["launches"] = C.parse(lines)
    return out


def card(device) -> str | None:
    if device not in (None, "cuda"):
        return None
    from sd_video_gen_tpu_torch.tools.bench_harness import card as smi
    return smi()


def main(argv=None) -> int:
    strict_f32()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "sdvg_cli_serving"))
    ap.add_argument("--streams", type=int, default=8,
                    help="--batch_clips (the benchmark's 8-stream point)")
    ap.add_argument("--pred_frames", type=int, default=4)
    ap.add_argument("--n_batches", type=int, default=8,
                    help="serving batches; batch 1 absorbs the start-up")
    ap.add_argument("--save_output", action="store_true",
                    help="also write the red-border PNGs (needs cv2)")
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "dpmpp"],
                    help="forwarded to predict --denoise_sampler")
    ap.add_argument("--solver_steps", type=int, default=None,
                    help="forwarded to predict --denoise_solver_steps")
    ap.add_argument("--cli_timeout_s", type=float, default=1800)
    ap.add_argument("--mode", default="batch", choices=["batch", "serve"],
                    help="batch: one-shot CLI steady rate (default); serve: "
                         "persistent server TTFF + per-request latency")
    ap.add_argument("--n_requests", type=int, default=6,
                    help="serve mode: requests after SERVE_READY")
    ap.add_argument("--dataset", default="ball", choices=["ball", "mnist"],
                    help="ball: the JAX tool's PNG tree (cv2); mnist: a "
                         "Moving-MNIST-layout .npy (numpy only)")
    ap.add_argument("--device", default=None,
                    help="the CLI's --device (default: the card)")
    args = ap.parse_args(argv)
    if args.n_batches < 3:
        ap.error("--n_batches must be >=3 for a meaningful steady window")
    max_clips = args.n_batches * args.streams  # exact multiple: one shape
    os.makedirs(args.workdir, exist_ok=True)
    paths = prepare(args.workdir, max_clips, args.dataset, args.device)

    if args.mode == "serve":
        r = run_serve_bench(paths, args.streams, args.pred_frames,
                            args.n_requests, args.cli_timeout_s,
                            sampler=args.sampler,
                            solver_steps=args.solver_steps,
                            device=args.device)
        r.update({
            "metric": "cli_serving_persistent_ttff",
            "streams": args.streams, "pred_frames": args.pred_frames,
            "sampler": args.sampler, "solver_steps": args.solver_steps,
            "card": card(args.device),
            "note": "ttff_warm_server_s: a warm server's first request; "
                    "the start-up is paid once, before SERVE_READY "
                    "(server_ready_wall_s)"})
        print(json.dumps(r))
        return 0

    t = run_cli(paths, max_clips, args.streams, args.pred_frames,
                args.save_output, args.cli_timeout_s,
                sampler=args.sampler, solver_steps=args.solver_steps,
                device=args.device)
    if t["clips"] != max_clips or not t.get("first_sync_s"):
        raise RuntimeError(f"unexpected timing payload: {t}")
    steady_clips = t["clips"] - args.streams
    steady_s = t["total_s"] - t["first_sync_s"]
    steady = steady_clips * args.pred_frames / steady_s
    absolute = t["clips"] * args.pred_frames / t["total_s"]
    print(json.dumps({
        "metric": "cli_serving_denoise_frames_per_sec",
        "steady_fps": round(steady, 2),
        "absolute_fps_incl_startup": round(absolute, 2),
        "streams": args.streams, "pred_frames": args.pred_frames,
        "batches": args.n_batches, "save_output": args.save_output,
        "sampler": args.sampler, "solver_steps": args.solver_steps,
        "timing": t, "card": card(args.device),
        "note": "steady = batches 2..N of one CLI process (start-up and the "
                "first batch excluded), comparable to the port's benchmark "
                "scenario vae_denoise_ar4_%dstreams" % args.streams}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
