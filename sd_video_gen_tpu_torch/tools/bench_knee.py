"""Knee search: the flagship training step across (precision, batch) and the
512px denoise pipeline across stream counts (``tools/bench_knee.py`` beside
the JAX package, on the port's benchmark).

  train:   ``bench.scenario_train(batch, precision)`` over the JAX tool's
           grid, in its order: the operating point behind
           ``train_flagship_tuned`` (the reference's batch 6 is a 3090-memory
           artifact)
  denoise: ``bench.scenario_denoise(batch)`` at 8, 16 and 32 streams: encode,
           predict, the 10-step DDIM refine at 512px and decode

Each point is timed by ``bench.time_requests``: one warm-up and
``bench.REPEATS`` timed requests, each closed by a synchronise, with exact
launches by body and every repeat's checksum equal to the warm-up's. No
trace and no FLOP count: the points stay cheap.

    python -m sd_video_gen_tpu_torch.tools.bench_knee [train|denoise|all]
        [--device cpu]

One JSON line per point, the JAX tool's keys (``case``, ``steps_per_s`` and
``clips_per_s``, or ``frames_per_s_chip``) and the record's median rate,
quartiles, spread and launches beside them. A point that runs out of device
memory prints the JAX tool's ``error`` line and the sweep goes on; any other
failure ends it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sd_video_gen_tpu_torch import bench
from sd_video_gen_tpu_torch.config import strict_f32

TRAIN_GRID = [("f32", 6), ("bf16", 6), ("bf16_full", 6), ("bf16_full", 24),
              ("bf16_full", 48), ("bf16_full", 96), ("bf16", 48)]
DENOISE_BATCHES = (8, 16, 32)


def points(which: str = "all") -> list:
    """``(case, scenario, kwargs)`` of the sweep ``which``, in the JAX
    tool's order."""
    out = []
    if which in ("all", "train"):
        out += [(f"train_{p}_b{b}", "scenario_train",
                 dict(batch=b, precision=p)) for p, b in TRAIN_GRID]
    if which in ("all", "denoise"):
        out += [(f"denoise_b{b}", "scenario_denoise", dict(batch=b))
                for b in DENOISE_BATCHES]
    return out


def run_point(case: str, scenario: str, kwargs: dict, sizes=bench.FULL,
              device="cuda", repeats: int = bench.REPEATS) -> dict:
    """One point: its JSON line, printed and returned. Only a device
    out-of-memory error is caught (the JAX tool's ``error`` line)."""
    try:
        wl = getattr(bench, scenario)(**kwargs, sizes=sizes, device=device)
        try:
            rec = bench.time_requests(case, wl, device, repeats)
        finally:
            del wl
            bench._free(device)
    except torch.cuda.OutOfMemoryError as e:
        bench._free(device)
        line = {"case": case, "error": str(e)[:160]}
        print(json.dumps(line), flush=True)
        return line
    v = rec["value"]
    line = {"case": case}
    if scenario == "scenario_train":
        line.update(steps_per_s=round(v, 2),
                    clips_per_s=round(v * rec["batch"], 1))
    else:
        line.update(frames_per_s_chip=round(v, 2))
    line.update({k: rec[k] for k in ("value", "unit", "q1", "q3", "best",
                                     "spread", "tries", "batch", "precision",
                                     "wall_s_median", "launches_in_run")},
                device=str(device))
    print(json.dumps(line), flush=True)
    return line


def main(argv=None, sizes=bench.FULL) -> int:
    strict_f32()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("which", nargs="?", default="all",
                        choices=("train", "denoise", "all"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: run on the host (no device numbers)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_knee: torch.cuda.is_available() is false; pass --device "
              "cpu to run on the host", file=sys.stderr)
        return 2
    for case, scenario, kwargs in points(args.which):
        run_point(case, scenario, kwargs, sizes, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
