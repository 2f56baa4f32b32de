"""The sharded programs compiled (``utils/jit.py`` over process groups, the
JAX package's ``jax.jit`` over a mesh) against the same programs eager, on
the CPU: two gloo workers (``tests/torch_mesh_jit_case.py``, started once
for the module) with the stand-in for CUDA graphs, which captures over any
group (``tests/torch_replay.py``), so the compiled path of every sharded
program runs here. On the card the same path runs over NCCL
(``chip_smoke.py --cards 4``); over gloo the card's backend refuses it
(``tests/test_torch_train_jit.py``).

  - the train step over a data group (data=2) and over a model axis
    (data=1,model=2), 3 steps with dropout on, eval and in-training FVD:
    compiled equals eager bit for bit (components, parameters, moments,
    FVD), one graph for each program, the all-reduces counted once a step;
  - ``predict.main --mesh data=1,model=2 --denoise`` (the split refiner's
    collectives and the sharded attention's routes inside the graphs),
    ``predict.main --mesh data=2 --denoise`` (each rank's noise rows) and
    ``predict_fvd.main --mesh data=2``: compiled equals eager bit for bit,
    with equal routes and all-reduce counts;
  - a request whose noise window differs from an earlier one of the same
    shape compiles a graph of its own, and its noise is its window's rows.

Against the JAX package and one process, the same entry points are held
in ``tests/test_torch_multiprocess.py`` and
``tests/test_torch_tensor_parallel.py``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_dp_case as DP
from tests import torch_mesh_jit_case as C
from tests import torch_tp_case as TP

from sd_video_gen_tpu_torch.config import load_config
from sd_video_gen_tpu_torch.diffusion.refine import (BatchWindow, draw_once,
                                                     windowed_noise)
from sd_video_gen_tpu_torch.train import checkpoint as ckpt
from sd_video_gen_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The data, the predict CLI's checkpoint (a one-process Trainer's
    initial state) and both workers' results."""
    root = str(tmp_path_factory.mktemp("mesh_jit_data"))
    out = str(tmp_path_factory.mktemp("mesh_jit_out"))
    DP.make_data(root)
    TP.make_mnist(root)
    tr = Trainer(load_config("dp", root), device="cpu", use_wandb=False,
                 checkpoint_dir=os.path.join(out, "ck"),
                 log_dir=os.path.join(out, "logs"))
    tr.init_state(seed=0)
    for path in (TP.init_checkpoint(root),      # --mode test, and train
                 TP.init_checkpoint(root)[:-len("test")] + "train"):
        ckpt.save_checkpoint(path, tr.state.state_dict())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_jit_case", str(r),
         str(WORLD), str(port), root, out], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("case", list(C.TRAIN))
def test_the_sharded_step_compiled_equals_eager(ranks, case):
    """3 steps with dropout on: every rank's loss components, parameters
    and moments equal its eager run's bit for bit; one graph served the
    steps; the gradient all-reduce counted once a step, as eagerly."""
    for res in ranks:
        got, want = res[case, "compiled"], res[case, "eager"]
        assert got["step"] == want["step"] == C.STEPS
        assert _equal_trees(got["steps"], want["steps"])
        assert _equal_trees(got["state"], want["state"])
        assert got["graphs"]["step"] == 1
        assert [n for n, _ in got["compiles"]].count("step_impl") == 1
        assert not want["compiles"] and not got["ruled_eager"]
        assert got["collectives"] == want["collectives"]
        grads = C.STEPS if case == "dp" else 0
        assert got["collectives"].get("grads", 0) == grads
    # the data-parallel ranks hold one state; the model ranks their shards
    if case == "dp":
        a, b = (r[case, "compiled"]["state"] for r in ranks)
        assert _equal_trees(a, b)
    steps = [r[case, "compiled"]["steps"][-1]["total"] for r in ranks]
    assert (steps[0] == steps[1]) == (case == "tp")


@pytest.mark.parametrize("case", list(C.TRAIN))
def test_eval_and_fvd_over_the_mesh_compiled_equal_eager(ranks, case):
    for res in ranks:
        got, want = res[case, "compiled"], res[case, "eager"]
        assert _equal_trees(got["evals"], want["evals"])
        assert np.isfinite(got["fvd"]) and got["fvd"] == want["fvd"]
        assert got["graphs"]["eval"] == 1 and got["graphs"]["fvd"] == 1


def test_predict_over_a_model_axis_compiled_equals_eager(ranks):
    """The split refiner at data=1,model=2: its collectives and the VAE
    attention's routes run inside the predictor's and the decode's graphs;
    the latents equal eager's, and the routes count as eagerly."""
    name = "predict_tp_denoise"
    for res in ranks:
        got, want = res[name, "compiled"], res[name, "eager"]
        assert _equal_trees(got["latents"], want["latents"])
        assert got["routes"] == want["routes"] and sum(got["routes"].values())
        assert {"predict_impl", "decode_impl"} <= {
            n for n, _ in got["compiles"]}
    a, b = (r[name, "compiled"]["latents"] for r in ranks)
    assert _equal_trees(a, b)           # the model ranks share their rows


def test_a_second_noise_window_gets_its_own_graph(ranks):
    """``predict.main --mesh data=2 --denoise`` over batches of 3 and 2:
    rank 1 rolls out one row of each, of one shape, with other noise rows
    ([2, 3) of 3, then [1, 2) of 2): two predictor graphs, and its latents
    equal eager's, which draws each window's rows afresh."""
    name = "predict_windows"
    for r, res in enumerate(ranks):
        got, want = res[name, "compiled"], res[name, "eager"]
        assert _equal_trees(got["latents"], want["latents"])
        shapes = [s for n, s in got["compiles"] if n == "predict_impl"]
        assert len(shapes) == 2
        assert (shapes[0] == shapes[1]) == (r == 1)
    one, two = ranks[1][name, "compiled"]["latents"]
    assert one.shape == two.shape and not torch.equal(one, two)


def test_fvd_over_the_data_axis_compiled_equals_eager(ranks):
    """``predict_fvd.main --mesh data=2``: the predictor, decode and I3D
    compiled on each rank, the statistics summed over the data axis on the
    host after the replays: FVD, MSE and every batch's statistics equal
    eager's; the sums counted as eagerly."""
    name = "fvd_data2"
    for res in ranks:
        got, want = res[name, "compiled"], res[name, "eager"]
        assert got["fvd"] == want["fvd"] and got["mse"] == want["mse"]
        assert _equal_trees(got["stats"], want["stats"])
        assert got["collectives"] == want["collectives"]
        assert got["collectives"]["fvd_stats"] == len(got["stats"])
        assert {"predict_impl", "decode_impl", "features"} <= {
            n for n, _ in got["compiles"]}


def test_every_compile_of_the_sharded_programs_was_a_capture(ranks):
    """Each key compiled once, and each compile captured its graph: no
    program of a group was left eager (the stand-in captures over gloo)."""
    for res in ranks:
        runs = [r for k, r in res.items() if k[1:] == ("compiled",)]
        assert len(runs) == len(C.TRAIN) + len(C.CLI)
        assert res["captures"] == sum(len(r["compiles"]) for r in runs) > 0
        assert not any(r["ruled_eager"] for r in runs)


def test_windowed_noise_is_the_windows_rows_of_one_draw():
    """Each window's noise is its rows of the whole batch's draw, taken
    once per (step, batch size)."""
    draws = []

    def noise(step, shape):
        g = torch.Generator().manual_seed(100 * step + shape[0])
        return torch.randn(shape, generator=g)

    def counted(step, shape):
        draws.append((step, tuple(shape)))
        return noise(step, shape)
    window = BatchWindow()
    draw = windowed_noise(draw_once(counted, "cpu"), window)
    got = {}
    for lo, hi, n in ((2, 3, 3), (1, 2, 2), (0, 2, 3), (2, 3, 3)):
        window.set(lo, hi, n)
        assert window.key() == (lo, hi, n)
        got[lo, hi, n] = draw(0, (hi - lo, 4, 4, 2))
        assert torch.equal(got[lo, hi, n], noise(0, (n, 4, 4, 2))[lo:hi])
    assert draws == [(0, (3, 4, 4, 2)), (0, (2, 4, 4, 2))]
    assert not torch.equal(got[2, 3, 3], got[1, 2, 2])
    window.set(0, 1, 3)
    with pytest.raises(ValueError, match="window holds"):
        draw(0, (2, 4, 4, 2))
