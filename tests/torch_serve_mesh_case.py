"""The sharded server of the port on the CPU, run by the worker processes
of ``tests/test_torch_serve_mesh.py`` in gloo groups. Imports torch and the
port only: the config, the checkpoint and the clips come from the files the
test writes under ``ROOT`` before it starts the workers.

Worker: ``python -m tests.torch_serve_mesh_case RANK WORLD PORT ROOT OUT
CASE`` (from the repository root). It serves ``CASES[CASE]`` on
``ROOT/CASE.sock`` with ``predict.main --serve ... --mesh ... --multihost``
until the test's client shuts it down; where the case has a batch CLI, it
then runs ``predict.main`` under the same mesh on the same clips
(``ROOT/CASE.npy``) and writes the decoded frames of its rows to
``OUT/CASE_rank<RANK>.pt``. After each ``predict.main`` no program of it is
alive. Case ``fail`` raises inside ``predict`` on rank
1 at the first request after the warm-up.
"""

from __future__ import annotations

import contextlib
import gc
import io
import os
import sys

import torch

from tests.torch_tp_case import tiny_sd

CONFIG = "tcfg"
YAML = """BATCH_SIZE:
 - 2
EPOCHS:
 - 1
FRAMES_PER_CLIP:
 - 5
FRAMES_TO_PREDICT:
 - 2
FRAME_SIZE: 32
DIM_MODEL:
 - 32
NUM_HEADS:
 - 4
NUM_ENCODER_LAYERS:
 - 1
NUM_DECODER_LAYERS:
 - 1
"""
# name -> (mesh, batch_clips, extra flags, runs the batch CLI)
CASES = {
    "data2": ("data=2", 4, ("--pred_frames", "3"), True),
    "model2": ("data=1,model=2", 2,
               ("--codec", "vae", "--denoise", "True",
                "--denoise_precision", "f32", "--denoise_start_step", "48",
                "--pred_frames", "1"), True),
    "text": ("data=2", 2, ("--train_mode", "text", "--pred_frames", "2"),
             False),
    "fail": ("data=2", 2, ("--pred_frames", "2"), False),
}


def checkpoint(root: str, case: str) -> str:
    return os.path.join(root, "text.pt" if case == "text" else "ref.pt")


def clips_path(root: str, case: str) -> str:
    return os.path.join(root, f"{case}.npy")


def sock_path(root: str, case: str) -> str:
    return os.path.join(root, f"{case}.sock")


def argv(root: str, case: str, *extra) -> list:
    """The CLI's flags for ``case`` (no mesh: one process)."""
    _, batch, flags, _ = CASES[case]
    return ["--dataset", "mnist", "--folder", clips_path(root, case),
            "--config", CONFIG, "--config_dir", root, "--torch_checkpoint",
            checkpoint(root, case), "--batch_clips", str(batch),
            "--device", "cpu", *flags, *extra]


@contextlib.contextmanager
def decoded(out: list):
    """Every decode's images of the CLIs started inside, appended to
    ``out``."""
    from sd_video_gen_tpu_torch.predict import predict as P
    real = P.make_decode_fn

    def make(*a, **kw):
        decode = real(*a, **kw)

        def run(x):
            imgs = decode(x)
            out.append(imgs.clone())
            return imgs
        return run
    P.make_decode_fn = make
    try:
        yield
    finally:
        P.make_decode_fn = real


@contextlib.contextmanager
def failing_predict(rank: int):
    """``predict`` raising on rank 1 at its second call (the first request
    after the warm-up)."""
    from sd_video_gen_tpu_torch.predict import predict as P
    real = P.make_predict_fn

    def make(*a, **kw):
        fn = real(*a, **kw)
        calls = []

        def run(*b, **kwb):
            calls.append(1)
            if rank == 1 and len(calls) == 2:
                raise RuntimeError("injected failure inside predict")
            return fn(*b, **kwb)
        return run
    P.make_predict_fn = make
    try:
        yield
    finally:
        P.make_predict_fn = real


def no_programs_alive() -> None:
    """``predict.main`` in a group has freed its programs as it returned
    (``multihost.releases_programs``), with no collection here: on the card
    a graph that outlives it would hold the destroy of an NCCL group."""
    from sd_video_gen_tpu_torch.utils.jit import jit
    live = [o.name for o in gc.get_objects() if isinstance(o, jit)]
    if live:
        raise AssertionError(f"programs alive after predict.main: {live}")


def main(args) -> None:
    rank, world, port, root, out_dir, case = args
    from sd_video_gen_tpu_torch.predict import predict as P
    torch.set_num_threads(1)
    mesh, _, _, batch_cli = CASES[case]
    group = ["--mesh", mesh, "--multihost", "--coordinator",
             f"127.0.0.1:{port}", "--num_processes", world, "--process_id",
             rank]
    with tiny_sd(), (failing_predict(int(rank)) if case == "fail"
                     else contextlib.nullcontext()):
        P.main(argv(root, case, "--serve", sock_path(root, case), *group))
        no_programs_alive()
        frames: list = []
        if batch_cli:
            with decoded(frames), contextlib.redirect_stdout(io.StringIO()):
                P.main(argv(root, case, "--max_clips", "1000", *group))
            no_programs_alive()
    torch.save({"frames": [f.numpy() for f in frames]},
               os.path.join(out_dir, f"{case}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
