"""Compiled sharded programs of the port against the same programs eager,
run by the worker processes of ``tests/test_torch_mesh_jit.py``: a gloo
group of 2 on the CPU, with the stand-in for CUDA graphs installed
(``tests/torch_replay.py``; it captures over gloo, as the card's backend
does over NCCL). Imports torch and the port only: the data, the configs
and the predict CLI's checkpoint are the files the test writes under
``ROOT`` before it starts the workers.

Worker: ``python -m tests.torch_mesh_jit_case RANK WORLD PORT ROOT OUT_DIR``
(from the repository root). It runs every case of ``TRAIN`` and ``CLI``,
compiled and then under ``disable_jit``, and writes what each saw to
``OUT_DIR/rank<RANK>.pt``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from tests import torch_tp_case as TP
from tests.torch_replay import ReplayGraphs

STEPS, DROPOUT = 3, 0.2
TRAIN = {"dp": "data=2", "tp": "data=1,model=2"}
# the predict CLI at data=2 over 5 clips (of the train split's 16) in
# batches of 3: rank 1 holds row [2, 3) of the first batch and row [1, 2)
# of the second, one row each, so its two requests share a shape and differ
# only in their noise window
WINDOWS = ("--mesh", "data=2", "--codec", "vae", "--denoise", "True",
           "--denoise_precision", "f32", "--denoise_start_step", "48",
           "--pred_frames", "1", "--max_clips", "5", "--batch_clips", "3",
           "--mode", "train")
CLI = ("predict_tp_denoise", "predict_windows", "fvd_data2")


def counts() -> dict:
    """Copies of the counters a replay must move as eager does."""
    from sd_video_gen_tpu_torch.ops.attention import TP_ROUTES
    from sd_video_gen_tpu_torch.parallel.multihost import COLLECTIVES
    from sd_video_gen_tpu_torch.utils import jit as J
    return {"collectives": dict(COLLECTIVES), "routes": dict(TP_ROUTES),
            "compiles": [(c["name"], c["shapes"]) for c in J.COMPILES],
            "ruled_eager": dict(J.RULED_EAGER)}


def reset() -> None:
    from sd_video_gen_tpu_torch.ops import _kernels
    from sd_video_gen_tpu_torch.utils import jit as J
    for c in _kernels.counters():
        c.clear()
    J.COMPILES.clear()
    J.RULED_EAGER.clear()


def batches(layout, stage: str) -> list:
    """STEPS seeded uint8 batches of this data rank's rows: another slice
    on every data rank, the same on the ranks of a model group."""
    rows = 8 // layout.data
    seed = {"train": 0, "val": 50}[stage] + 10 * layout.data_rank
    return [np.random.default_rng(seed + s).integers(
        0, 256, (rows, 5, 16, 16, 3), dtype=np.uint8) for s in range(STEPS)]


def run_train(root: str, work: str, mesh: str) -> dict:
    """STEPS steps with dropout on, two eval batches and in-training FVD
    (a seeded stand-in for I3D) of one Trainer under ``mesh``, from seed
    0; what each returned, the state after, the counts."""
    from sd_video_gen_tpu_torch.config import load_config
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    reset()
    cfg = load_config("dp", root).replace(dropout_p=DROPOUT)
    tr = Trainer(cfg, argparse.Namespace(mesh=mesh, device="cpu"),
                 mode="ar", codec_kind="pixel", use_wandb=False,
                 checkpoint_dir=os.path.join(work, "ck"),
                 log_dir=os.path.join(work, "logs"))
    tr.init_state(seed=0)
    train, val = batches(tr.layout, "train"), batches(tr.layout, "val")
    steps = [tr._step_fn(tr.state, b, 0)[1] for b in train]
    evals = [tr._eval_fn(b) for b in val[:2]]
    fvd = tr.fvd_validation([(None, b) for b in val[:2]], TP.StubI3D())
    sd = tr.state.state_dict()
    return {"steps": steps, "evals": evals, "fvd": fvd,
            "state": {t: {k: v.clone() for k, v in sd[t].items()}
                      for t in ("params", "mu", "nu")},
            "step": tr.state.step,
            "graphs": {"step": tr._step_fn.impl.n_graphs,
                       "eval": tr._eval_fn.impl.n_graphs,
                       "fvd": tr._fvd_batch.n_graphs},
            **counts()}


def run_cli(root: str, work: str, name: str) -> dict:
    reset()
    os.makedirs(work)
    with contextlib.chdir(work):
        out = TP.run_cli(root, name)
    return {**out, **counts()}


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    root, out_dir = argv[3:5]
    torch.set_num_threads(1)
    from sd_video_gen_tpu_torch.parallel import multihost
    from sd_video_gen_tpu_torch.utils import jit as J
    J.BACKEND = ReplayGraphs()
    TP.CLI_RUNS["predict_windows"] = WINDOWS
    multihost.initialize(f"127.0.0.1:{port}", world, rank, "cpu")
    work = os.path.join(out_dir, f"rank{rank}")
    res = {}
    for how in ("compiled", "eager"):
        with J.disable_jit() if how == "eager" else contextlib.nullcontext():
            for case, mesh in TRAIN.items():
                res[case, how] = run_train(
                    root, os.path.join(work, how, case), mesh)
            for name in CLI:
                res[name, how] = run_cli(
                    root, os.path.join(work, how, name), name)
    res["captures"] = J.BACKEND.captures
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
