"""Data-parallel training across processes on the CPU: two processes joined
by ``torch.distributed`` over gloo, each on half of every global batch,
against the JAX trainer on the whole batch, and against one process of the
port on the whole batch; both loaders (``BatchLoader``, the native cache),
modes ``ar`` and ``text``, dropout 0 (``tests/torch_dp_case.py``). Every run
starts from the JAX trainer's initial state, bridged to the port. The JAX
trainer (a one-device mesh) reads the same global batches from the port's
unsharded loaders, which are held byte-equal to the JAX package's in
``test_torch_native_loader.py`` and ``test_torch_config_data.py``. The two
workers are started once for the module and run every case.

Tolerances, f32 (summation order only). Loss components, train and val, of
every epoch: rtol 1e-5 (a rank's is the mean of two half-batch means, the
reference's one whole-batch mean). These are what tells a gradient mean from
a sum; so are the second moments, ``nu`` ~ g^2: ``mu`` and ``nu`` per tensor
rel L2 1e-4 against JAX (the training tests' bound). Parameters: Adam's
first updates are ``lr * g / (|g| + eps)``, so where ``|g|`` is rounding
noise (attention key biases) the sign may flip between two runs: every
element is held to ``2 * lr`` per step, and every element whose first moment
has stayed above 1e-5 at every step in both runs to ``0.05 * lr`` per step (the training tests'
bound against JAX, ROADMAP "Not faults"); the same bounds hold the two
processes against the port's one. The pooled FVD statistics: the
mean and covariance of all ranks' features, rtol 1e-12 (f64).
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests import torch_dp_case as C

from sd_video_gen_tpu.config import load_config as jload_config
from sd_video_gen_tpu.parallel import make_mesh as jmake_mesh
from sd_video_gen_tpu.train.trainer import Trainer as JTrainer
from sd_video_gen_tpu_torch.diffusion.weights import train_state_from_jax
from sd_video_gen_tpu_torch.evaluation.fvd import FeatureStats
from sd_video_gen_tpu_torch.parallel import (default_mesh_for_batch,
                                             multihost, parse_mesh_spec)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
WORLD = 2


def _jax_trainer(root, mode, workdir):
    """The JAX trainer of ``mode`` on one device, and its initial state
    from seed 0 (on the host)."""
    trainer = JTrainer(jload_config("dp", root), mode=mode,
                       codec_kind="pixel",
                       mesh=jmake_mesh("data=1,model=1", jax.devices()[:1]),
                       num_classes=C.CLASSES, use_wandb=False,
                       checkpoint_dir=os.path.join(workdir, "ck"))
    trainer.logger.quiet = True
    sample = np.zeros((C.BATCH, 5, 16, 16, 3), np.uint8)
    trainer.init_state(sample, seed=0,
                       sample_text_embeds=trainer._texts([0] * C.BATCH))
    return trainer, jax.device_get(trainer.state)


def _bridged(state) -> dict:
    return train_state_from_jax(jax.device_get(state.params),
                                jax.device_get(state.opt_state),
                                int(state.step))


def _jax_run(trainer, init, root, kind, mode):
    """``run_case``'s epochs through the JAX trainer on the whole batch,
    from ``init``."""
    trainer.state = init
    trainer._shard_state()
    floor, step_fn = {}, trainer._step_fn

    def step(*args):
        state, comps = step_fn(*args)
        C.lower_floor(floor, _bridged(state)["mu"])
        return state, comps

    trainer._step_fn = step
    train = C.loader(root, kind, mode, "train")
    val = C.loader(root, kind, mode, "test")
    out = {"train": [], "val": [], "mu_floor": floor}
    try:
        for _ in range(C.EPOCHS):
            out["train"].append(trainer.train_loop(train,
                                                   jax.random.PRNGKey(0)))
            out["val"].append(trainer.validation_loop(val))
    finally:
        trainer._step_fn = step_fn
    out.update(_bridged(trainer.state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The data and the JAX initial states; the workers' results (every
    case in one process group); here meanwhile, the single-process runs and
    the JAX runs of every case."""
    root = str(tmp_path_factory.mktemp("dp_data"))
    out = str(tmp_path_factory.mktemp("dp_out"))
    C.make_data(root)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_case", str(r), str(WORLD),
         str(port), root, out], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    mp = pytest.MonkeyPatch()
    mp.chdir(out)                     # the JAX trainer logs under ./logs
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    logs = []
    try:
        # the workers run the CLI meanwhile, then wait for these
        jax_trainers = {}
        for mode in ("ar", "text"):
            jax_trainers[mode] = _jax_trainer(root, mode, out)
            path = C.init_path(root, mode)
            torch.save(_bridged(jax_trainers[mode][1]), path + ".tmp")
            os.replace(path + ".tmp", path)
        single = {case: C.run_case(root, *case, os.path.join(out, "single"))
                  for case in C.CASES}
        ref = {(kind, mode): _jax_run(*jax_trainers[mode], root, kind, mode)
               for kind, mode in C.CASES}
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        torch.set_num_threads(n)
        mp.undo()
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return dict(root=root, out=out, single=single, ranks=ranks, ref=ref)


def _components(epochs, key):
    names = [sorted(k for k in m if k.endswith(key)) for m in epochs]
    return names[0], np.array([[m[k] for k in n] for m, n in
                               zip(epochs, names)])


def _check_state(got, want, steps):
    """``got`` against ``want`` (the port's state-dict trees), the bounds
    of the module docstring."""
    for tree in ("mu", "nu"):
        for k, w in want[tree].items():
            assert torch.linalg.vector_norm(got[tree][k] - w) <= \
                1e-4 * torch.linalg.vector_norm(w) + 1e-12, (tree, k)
    for k, w in want["params"].items():
        diff = (got["params"][k] - w).abs()
        assert diff.max() <= 2 * LR * steps * 1.001, k
        settled = (want["mu_floor"][k] > 1e-5) & (got["mu_floor"][k] > 1e-5)
        if settled.any():
            assert diff[settled].max() <= 0.05 * LR * steps, k


def _check_losses(got, want):
    for key in ("_train", "_val"):
        gk, g = _components(got[key[1:]], key)
        wk, w = _components(want[key[1:]], key)
        assert gk == wk and len(gk) >= 2
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind,mode", C.CASES)
def test_each_process_matches_jax_on_the_whole_batch(runs, kind, mode):
    """Every rank's epoch losses and final state against the JAX trainer's
    on the whole global batch, from the same initial state; and the port's
    one process on the whole batch too."""
    want = runs["ref"][kind, mode]
    assert want["step"] == C.EPOCHS * 2
    for res in [runs["single"][kind, mode]] + [r[kind, mode]
                                               for r in runs["ranks"]]:
        assert res["step"] == want["step"]
        _check_losses(res, want)
        _check_state(res, want, want["step"])


@pytest.mark.parametrize("kind,mode", C.CASES)
def test_two_processes_match_one_on_the_whole_batch(runs, kind, mode):
    one = runs["single"][kind, mode]
    for res in runs["ranks"]:
        two = res[kind, mode]
        assert two["step"] == one["step"] == C.EPOCHS * 2
        _check_losses(two, one)
        # each process timed its own steps: half the batch, same count
        assert [m["steps_timed"] for m in two["train"]] == [2] * C.EPOCHS
        _check_state(two, one, one["step"])
    # the processes hold the same state, exactly
    a, b = (r[kind, mode] for r in runs["ranks"])
    assert all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])
    assert a["train"][-1]["total_train"] == b["train"][-1]["total_train"]


def test_the_cli_joins_from_its_flags_and_rank_0_alone_writes(runs):
    """``--multihost --coordinator --num_processes --process_id`` through
    ``train.trainer.main`` on both workers: gloo, every rank with the same
    history; the checkpoint and the log are rank 0's, rank 1 writes
    neither; one gradient all-reduce a step, one loss reduction a loop."""
    r0, r1 = runs["ranks"]
    assert r0["group"] == (0, 2, "gloo") and r1["group"] == (1, 2, "gloo")
    (h0,), (h1,) = r0["cli"], r1["cli"]
    strip = lambda h: [{k: v for k, v in m.items() if "step_ms" not in k}
                       for m in h]
    assert strip(h0) == strip(h1)
    assert [m["epoch"] for m in h0] == [1, 2]
    assert all(np.isfinite(m["train_loss"]) and np.isfinite(m["val_loss"])
               for m in h0)
    out = runs["out"]
    assert sorted(os.listdir(os.path.join(out, "ck"))) == ["dp_0_test"]
    saved = torch.load(os.path.join(out, "ck", "dp_0_test", "state.pt"),
                       weights_only=True)
    assert saved["step"] == 4
    assert os.listdir(os.path.join(out, "rank0", "logs")) == ["dp_0.jsonl"]
    assert not os.path.exists(os.path.join(out, "rank1", "logs"))
    # the CLI's 4 steps and 4 cases x 4 steps; a train and a val loop an
    # epoch, 2 epochs, in the CLI and each case; the FVD check's one pooling
    for r in (r0, r1):
        assert r["collectives"] == {"grads": 4 + 16, "metrics": 4 + 16,
                                    "fvd_stats": 1}


def test_fvd_statistics_pool_over_processes(runs):
    want = FeatureStats(4).append(np.concatenate(
        [C.fvd_features(r) for r in range(WORLD)])).mean_cov()
    for res in runs["ranks"]:
        for got, w in zip(res["fvd_stats"], want):
            np.testing.assert_allclose(got, w, rtol=1e-12, atol=1e-14)


# (a mesh with a model axis raised NotImplementedError until tensor
# parallelism was ported; those two cases keep their ids and now hold the
# device count to the spec)
@pytest.mark.parametrize("spec,n,err,match", [
    (None, 3, None, None),
    ("data=2", 2, None, None),
    ("data=2,model=1", 2, None, None),
    pytest.param("model=2", 1, ValueError, "needs 2 devices, have 1",
                 id="model=2-1-NotImplementedError---mesh "
                    "model=2.*tensor-parallel"),
    pytest.param("data=1,model=2", 1, ValueError, "needs 2 devices, have 1",
                 id="data=1,model=2-1-NotImplementedError-tensor-parallel"),
    ("data=2", 1, ValueError, "needs 2 devices, have 1.*one process per "
     "device.*torchrun.*--multihost"),
    ("data=2,modle=1", 2, ValueError, "unknown mesh axis 'modle'")])
def test_mesh_specs(spec, n, err, match):
    if err is None:
        assert parse_mesh_spec(spec, n) == {"data": n, "model": 1}
    else:
        with pytest.raises(err, match=match):
            parse_mesh_spec(spec, n)


def test_one_process_defaults(monkeypatch):
    """Without a group: rank 0 of 1, the coordinator; the default mesh is
    one process; a batch must divide over the processes; a card asked for
    without an index stays as it is; the slice lands on its device."""
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_coordinator()
    assert default_mesh_for_batch(6) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="divisible by the 4 processes"):
        default_mesh_for_batch(6, 4)
    assert multihost.rank_device(torch.device("cuda")) == torch.device("cuda")
    x = np.arange(6, dtype=np.uint8).reshape(2, 3)
    t = multihost.global_batch_from_local(x, "cpu")
    assert t.dtype == torch.uint8 and t.tolist() == x.tolist()
    multihost.barrier()                    # no group: returns
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--coordinator, --num_processes, "
                       "--process_id.*torchrun"):
        multihost.initialize(device="cpu")
