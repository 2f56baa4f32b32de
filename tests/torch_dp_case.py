"""Tiny data-parallel training cases of the port, shared by
``tests/test_torch_multiprocess.py`` (one process on the whole batch) and
its worker processes (each on its slice, joined by ``torch.distributed``
over gloo on the CPU). Imports torch and the port only. Every case starts
from the state the test writes to ``init_path(root, mode)``: the JAX
trainer's initial state, bridged to the port's parameter names.

Worker: ``python -m tests.torch_dp_case RANK WORLD PORT DATA_DIR OUT_DIR``
(from the repository root). It joins the group through the trainer's CLI
(``--multihost --coordinator ...``), then, once the initial states are
there, runs every case of ``CASES`` and writes its results to
``OUT_DIR/rank<RANK>.pt``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

CASES = [(loader, mode) for loader in ("pipeline", "native")
         for mode in ("ar", "text")]
EPOCHS, BATCH, CLASSES = 2, 8, 64
YAML = ('{"LR": [0.0001], "BATCH_SIZE": [8], "EPOCHS": [2], '
        '"FRAMES_PER_CLIP": [5], "FRAMES_TO_PREDICT": [2], "FRAME_SIZE": 16, '
        '"DIM_MODEL": [32], "NUM_HEADS": [4], "NUM_ENCODER_LAYERS": [1], '
        '"NUM_DECODER_LAYERS": [1], "DROPOUT_P": [0.0], '
        '"USE_CONTRASTIVE": [false]}')


class Labelled:
    """Clip i of ``inner`` under class (5 i + 3) % CLASSES."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return (5 * i + 3) % CLASSES, self.inner[i][1]


def make_data(root: str) -> None:
    """A ball tree (8 train sequences of 10 frames at 16px: 16 clips of 5,
    two global batches of 8; 2 test sequences: 4 clips, a ragged batch), its
    native caches (``cache``: ball ids; ``cache_text``: class labels) and
    the CLI's config."""
    from sd_video_gen_tpu_torch.data import (BouncingBallDataset,
                                             generate_bouncing_ball_tree)
    from sd_video_gen_tpu_torch.data.native_loader import build_frame_cache
    generate_bouncing_ball_tree(root, 8, 2, 10, 16, seed=0)
    for stage in ("train", "test"):
        ds = BouncingBallDataset(5, 1, root, stage, seed=3)
        build_frame_cache(ds, os.path.join(root, "cache"), stage)
        build_frame_cache(Labelled(ds), os.path.join(root, "cache_text"),
                          stage)
    with open(os.path.join(root, "dp.yml"), "w") as f:
        f.write(YAML)


def lower_floor(floor: dict, mu: dict) -> None:
    """``floor``: the smallest |mu| of every element over the steps so far,
    by name (updated here)."""
    for k, m in mu.items():
        floor[k] = torch.minimum(floor[k], m.abs()) if k in floor \
            else m.abs()


def init_path(root: str, mode: str) -> str:
    return os.path.join(root, f"init_{mode}.pt")


def loader(root, kind, mode, stage, shard=None):
    """``kind``'s loader of ``stage`` (this process's slice of every global
    batch when ``shard`` = (rank, count); the whole batch when None)."""
    from sd_video_gen_tpu_torch.data import BatchLoader, BouncingBallDataset
    from sd_video_gen_tpu_torch.data.native_loader import NativeBatchLoader
    from sd_video_gen_tpu_torch.train.trainer import _LabelMappedLoader
    if kind == "native":
        cache = os.path.join(root, "cache_text" if mode == "text" else "cache")
        loader = NativeBatchLoader(cache, stage, BATCH, seed=7, n_threads=1,
                                   process_shard=shard)
        return _LabelMappedLoader(loader) if mode == "text" else loader
    ds = BouncingBallDataset(5, 1, root, stage, seed=3)
    return BatchLoader(Labelled(ds) if mode == "text" else ds, BATCH, seed=7,
                       process_shard=shard)


def run_case(root: str, kind: str, mode: str, workdir: str,
             shard=None) -> dict:
    """EPOCHS epochs of train + validation loops of a tiny FrameTransformer
    (dropout 0) over ``kind``'s loader; this process's slice of every global
    batch when ``shard`` = (rank, count), from the state at
    ``init_path(root, mode)``. Returns the epochs' train and val components,
    the final parameters and moments, and the smallest |mu| of every
    element over the steps (on the host)."""
    from sd_video_gen_tpu_torch.config import load_config
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    cfg = load_config("dp", root)
    trainer = Trainer(cfg, mode=mode, codec_kind="pixel", device="cpu",
                      num_classes=CLASSES, use_wandb=False,
                      checkpoint_dir=os.path.join(workdir, "ck"),
                      log_dir=os.path.join(workdir, "logs"))
    trainer.logger.quiet = True
    trainer.init_state(seed=0)
    trainer.state.load_state_dict(torch.load(init_path(root, mode),
                                             weights_only=True))
    floor, step_fn = {}, trainer._step_fn

    def step(*args):
        state, comps = step_fn(*args)
        lower_floor(floor, state.opt_state["mu"])
        return state, comps

    trainer._step_fn = step
    train = loader(root, kind, mode, "train", shard)
    val = loader(root, kind, mode, "test", shard)
    out = {"train": [], "val": [], "mu_floor": floor}
    for _ in range(EPOCHS):
        out["train"].append(trainer.train_loop(train))
        out["val"].append(trainer.validation_loop(val))
    sd = trainer.state.state_dict()
    for tree in ("params", "mu", "nu"):
        out[tree] = {k: v.clone() for k, v in sd[tree].items()}
    out["step"] = trainer.state.step
    return out


def fvd_features(rank: int) -> np.ndarray:
    """Rank ``rank``'s features for the pooled-statistics check."""
    return np.random.default_rng(rank).standard_normal((6 + rank, 4))


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    root, out_dir = argv[3:5]
    torch.set_num_threads(1)
    from sd_video_gen_tpu_torch.evaluation.fvd import FeatureStats
    from sd_video_gen_tpu_torch.parallel import multihost
    from sd_video_gen_tpu_torch.train import trainer as T
    work = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(work)
    os.chdir(work)                    # the CLI's logs go to ./logs
    res = {}
    # the CLI first: it joins the group from its flags
    res["cli"] = T.main([
        "--dataset", "ball", "--config", "dp", "--config_dir", root,
        "--native_cache", os.path.join(root, "cache"), "--checkpoint_dir",
        os.path.join(out_dir, "ck"), "--debug", "True", "--device", "cpu",
        "--multihost", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", str(world), "--process_id", str(rank)])
    res["group"] = (multihost.process_index(), multihost.process_count(),
                    torch.distributed.get_backend())
    # the test writes the initial states while the workers start
    end = time.monotonic() + 120
    while not all(os.path.exists(init_path(root, m)) for m in ("ar", "text")):
        if time.monotonic() > end:
            raise TimeoutError(f"no initial states under {root}")
        time.sleep(0.05)
    for kind, mode in CASES:
        res[kind, mode] = run_case(root, kind, mode, work, (rank, world))
    trainer = T.Trainer(T.load_config("dp", root), device="cpu",
                        use_wandb=False, checkpoint_dir=work,
                        log_dir=os.path.join(work, "logs"))
    pooled = trainer._pooled(FeatureStats(4).append(fvd_features(rank)))
    res["fvd_stats"] = pooled.mean_cov()
    res["collectives"] = dict(multihost.COLLECTIVES)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
