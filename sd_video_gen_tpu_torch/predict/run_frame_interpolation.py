"""Frame interpolation over predicted outputs with Google FILM
(``sd_video_gen_tpu/predict/run_frame_interpolation.py``).

Regroups frames ``--start``..``--end`` of each ``outputs/<n>/`` rollout into
``<work_dir>/counter_<n>/`` and runs FILM's
``frame_interpolation.eval.interpolator_cli`` on them
(``--times_to_interpolate``). FILM is an external package with its own
weights; without it only ``--regroup_only`` runs.

  python -m sd_video_gen_tpu_torch.predict.run_frame_interpolation \
      --outputs_dir outputs --work_dir predicted_images \
      [--start 8 --end 12 --times 2] [--regroup_only]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import subprocess
import sys

from sd_video_gen_tpu_torch.config import strict_f32


def regroup_outputs(outputs_dir: str, work_dir: str, start: int = 8,
                    end: int = 12) -> list[str]:
    """Copy frames [start, end] of each outputs/<n>/ into
    <work_dir>/counter_<n>/ as <i:03d>.png (the FILM input layout)."""
    groups = []
    for n in sorted(os.listdir(outputs_dir)):
        src = os.path.join(outputs_dir, n)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(work_dir, f"counter_{n}")
        os.makedirs(dst, exist_ok=True)
        for i in range(start, end + 1):
            f = os.path.join(src, f"{i}.png")
            if os.path.exists(f):
                shutil.copy(f, os.path.join(dst, f"{i:03d}.png"))
        groups.append(dst)
    return groups


def run_film(work_dir: str, times: int = 2,
             model_path: str = "pretrained_models/film_net/Style/saved_model"):
    if importlib.util.find_spec("frame_interpolation") is None:
        raise ModuleNotFoundError(
            "Google FILM (frame_interpolation) is not installed; "
            "interpolated_frames/ will not be produced. Install "
            "github.com/google-research/frame-interpolation to enable.")
    # this interpreter, where find_spec looked, not whatever "python" is
    subprocess.run(
        [sys.executable, "-m", "frame_interpolation.eval.interpolator_cli",
         "--pattern", f"{work_dir}/counter_*", "--model_path", model_path,
         "--times_to_interpolate", str(times)], check=True)


def main(argv=None):
    strict_f32()
    p = argparse.ArgumentParser()
    p.add_argument("--outputs_dir", default="outputs")
    p.add_argument("--work_dir", default="predicted_images")
    p.add_argument("--start", type=int, default=8)
    p.add_argument("--end", type=int, default=12)
    p.add_argument("--times", type=int, default=2)
    p.add_argument("--regroup_only", action="store_true")
    args = p.parse_args(argv)
    groups = regroup_outputs(args.outputs_dir, args.work_dir, args.start,
                             args.end)
    print(f"regrouped {len(groups)} rollouts into {args.work_dir}/")
    if not args.regroup_only:
        run_film(args.work_dir, args.times)


if __name__ == "__main__":
    main()
