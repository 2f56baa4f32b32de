"""The port's train checkpoints (``sd_video_gen_tpu_torch/train/
checkpoint.py``) on the CPU: the JAX package's naming and index, exact
save / restore of parameters, both moments and the step, a run interrupted
and resumed against the uninterrupted one bit for bit, the non-blocking
save, the format stamp and the v1 -> v2 migration.

Tolerance: none. Everything here is held bit for bit (same device, same
generator seeding).
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from sd_video_gen_tpu.train import checkpoint as JC
from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.train import checkpoint as PC
from sd_video_gen_tpu_torch.train.trainer import Trainer

CFG = Config(config_name="ckpt_cfg", lr=1e-3, batch_size=2,
             frames_per_clip=3, frames_to_predict=2, frame_size=32,
             dim_model=32, num_heads=4, num_encoder_layers=1,
             num_decoder_layers=1, dropout_p=0.1)
FRAMES = np.random.default_rng(0).integers(0, 256, (2, 3, 32, 32, 3),
                                           dtype=np.uint8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the metrics logger writes ./logs
    return tmp_path


def _trainer(workdir, precision="f32", seed=0, init=True):
    tr = Trainer(CFG, mode="ar", device="cpu", use_wandb=False,
                 precision=precision, checkpoint_dir=str(workdir / "ck"))
    tr.logger.quiet = True
    if init:
        tr.init_state(seed=seed)
    return tr


def _steps(tr, n, seed=0):
    return [float(tr._step_fn(tr.state, FRAMES, seed)[1]["total"])
            for _ in range(n)]


def _assert_states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for tree in ("params", "mu", "nu"):
        assert list(sa[tree]) == list(sb[tree])
        for k, v in sa[tree].items():
            assert v.dtype == sb[tree][k].dtype
            assert torch.equal(v, sb[tree][k]), (tree, k)


@pytest.mark.parametrize("names", [[], ["ckpt_cfg_0_test"],
                                   ["ckpt_cfg_0_test", "ckpt_cfg_1_train.pt",
                                    "other_0_test", "xckpt_cfg_big_3_test"]])
def test_naming_and_index_are_the_jax_packages(tmp_path, names):
    for n in names:
        (tmp_path / n).mkdir()
    d = str(tmp_path)
    assert PC.checkpoint_index(d, "ckpt_cfg") == \
        JC.checkpoint_index(d, "ckpt_cfg") == sum("ckpt_cfg" in n
                                                  for n in names)
    assert PC.checkpoint_index(d + "/missing", "c") == 0
    for mode in ("test", "train", "interrupt"):
        assert PC.checkpoint_path(d, "ckpt_cfg", 3, mode) == \
            JC.checkpoint_path(d, "ckpt_cfg", 3, mode)
    assert PC.FORMAT_VERSION == JC.FORMAT_VERSION == 2
    assert PC._FORMAT_FILE == JC._FORMAT_FILE == "sdvg_format.json"


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16_full"])
def test_save_restore_is_bit_equal(workdir, precision):
    tr = _trainer(workdir, precision)
    _steps(tr, 2)
    path = tr.save("test")
    assert path == PC.checkpoint_path(str(workdir / "ck"), "ckpt_cfg", 0,
                                      "test")
    assert sorted(os.listdir(path)) == ["sdvg_format.json", "state.pt"]
    assert PC.read_format_version(path) == 2
    other = _trainer(workdir, precision, seed=5)
    other.resume("ckpt_cfg_0_test")
    assert other.state.step == 2
    _assert_states_equal(tr.state, other.state)
    want = torch.bfloat16 if precision == "bf16_full" else torch.float32
    assert all(v.dtype == want for v in other.state.opt_state["mu"].values())


def test_interrupted_run_equals_the_uninterrupted_one(workdir):
    """2 steps, an interrupt checkpoint, a fresh Trainer, ``resume``, 2 more
    steps: losses, parameters and moments equal those of 4 steps in a row,
    bit for bit (dropout on: the draws follow the step number)."""
    straight = _trainer(workdir)
    want = _steps(straight, 4)
    first = _trainer(workdir)
    got = _steps(first, 2)
    first.save("interrupt")
    second = _trainer(workdir, seed=9)          # other initial weights
    second.resume("ckpt_cfg_0_interrupt")
    got += _steps(second, 2)
    assert got == want
    _assert_states_equal(straight.state, second.state)
    # without the resume the draws differ: the comparison above can fail
    fresh = _trainer(workdir)
    fresh.state.step = 2
    assert _steps(fresh, 1) != want[2:3]


def test_nonblocking_save_then_finalize(workdir):
    tr = _trainer(workdir)
    _steps(tr, 1)
    path = PC.checkpoint_path(str(workdir / "ck"), "ckpt_cfg", 0, "train")
    before = {k: v.clone() for k, v in tr.state.state_dict()["params"].items()}
    PC.save_checkpoint(path, tr.state.state_dict(), block=False)
    _steps(tr, 1)                    # the live tensors move on meanwhile
    PC.finalize_saves()
    assert PC.read_format_version(path) == 2 and not PC._PENDING
    saved = PC.restore_checkpoint(path, tr.state.state_dict())
    assert saved["step"] == 1
    for k, v in before.items():
        assert torch.equal(saved["params"][k], v)
    assert any(not torch.equal(v, tr.state.params[k].detach())
               for k, v in before.items())
    # restore drains a save in flight by itself, and a second save to the
    # same path waits for the first
    PC.save_checkpoint(path, tr.state.state_dict(), block=False)
    PC.save_checkpoint(path, tr.state.state_dict(), block=False)
    assert PC.restore_checkpoint(path, tr.state.state_dict())["step"] == 2
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]


def test_a_failed_background_save_is_raised_by_finalize(workdir):
    tr = _trainer(workdir)
    blocker = workdir / "ck" / "a_file"
    blocker.write_text("x")
    PC.save_checkpoint(str(blocker / "sub"), tr.state.state_dict(),
                       block=False)
    with pytest.raises(RuntimeError, match="saving .* failed"):
        PC.finalize_saves()
    PC.finalize_saves()              # drained: nothing left to raise


def test_stamp_and_unstamped_current_structure(workdir):
    tr = _trainer(workdir)
    path = tr.save("test")
    with open(os.path.join(path, "sdvg_format.json")) as f:
        assert json.load(f) == {"format_version": 2}
    os.remove(os.path.join(path, "sdvg_format.json"))
    assert PC.read_format_version(path) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no migration story
        restored = PC.restore_checkpoint(path, tr.state.state_dict())
    assert restored["step"] == 0
    with pytest.raises(FileNotFoundError):
        PC.restore_checkpoint(str(workdir / "ck" / "nothing"),
                              tr.state.state_dict())


def _strip_v2(sd):
    return {"step": sd["step"],
            **{tree: {k: v for k, v in sd[tree].items()
                      if not PC._is_v2_new(k)}
               for tree in ("params", "mu", "nu")}}


def test_v1_migration_fills_the_final_norms_and_warns(workdir):
    tr = _trainer(workdir)
    _steps(tr, 2)
    full = tr.state.state_dict()
    stripped = _strip_v2(full)
    assert len(stripped["params"]) == len(full["params"]) - 4
    path = str(workdir / "ck" / "ckpt_cfg_0_old")
    os.makedirs(path)
    torch.save(PC._to_host(stripped), os.path.join(path, "state.pt"))
    other = _trainer(workdir, seed=3)
    with pytest.warns(UserWarning, match="format v1.*fresh Adam"):
        other.resume("ckpt_cfg_0_old")
    got = other.state.state_dict()
    assert got["step"] == 2
    for tree in ("params", "mu", "nu"):
        for k, v in got[tree].items():
            if not PC._is_v2_new(k):
                assert torch.equal(v, full[tree][k])
            elif tree == "params" and k.endswith(".weight"):
                assert torch.equal(v, torch.ones_like(v))
            else:
                assert torch.equal(v, torch.zeros_like(v))
    # a stamped checkpoint is never migrated
    PC._stamp(path)
    with pytest.raises(ValueError, match="does not match the train state"):
        PC.restore_checkpoint(path, full)


def test_wrong_structure_raises_the_original_error(workdir):
    """An unstamped file that is neither the current structure nor a v1
    state (another model's) raises the current-structure error, with no
    migration warning."""
    tr = _trainer(workdir)
    wrong = tr.state.state_dict()
    wrong = {"step": 0, **{tree: {k + "_x": v for k, v in wrong[tree].items()}
                           for tree in ("params", "mu", "nu")}}
    path = str(workdir / "ck" / "wrong")
    os.makedirs(path)
    torch.save(PC._to_host(wrong), os.path.join(path, "state.pt"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="does not match the train "
                                             "state.*missing"):
            PC.restore_checkpoint(path, tr.state.state_dict())
    # another width: same names, other shapes
    bad = tr.state.state_dict()
    bad = {"step": 0, **{tree: {k: torch.zeros(3) for k in bad[tree]}
                         for tree in ("params", "mu", "nu")}}
    torch.save(bad, os.path.join(path, "state.pt"))
    with pytest.raises(ValueError, match="mismatched"):
        PC.restore_checkpoint(path, tr.state.state_dict())


def test_resume_from_a_reference_pt_state_dict(workdir):
    """A reference ``.pt`` of the same name: ``load_state_dict`` with fresh
    moments; the positional buffer the reference saved is dropped."""
    tr = _trainer(workdir)
    _steps(tr, 1)
    sd = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    sd["positional_encoder.pos_encoding"] = torch.zeros(64, 1, 32)
    torch.save(sd, str(workdir / "ck" / "ref_0_test.pt"))
    other = _trainer(workdir, seed=4)
    other.resume("ref_0_test")
    assert other.state.step == 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v)
    assert all(not m.any() for m in other.state.opt_state["mu"].values())
    sd["stray.weight"] = torch.zeros(1)
    torch.save(sd, str(workdir / "ck" / "ref_1_test.pt"))
    with pytest.raises(RuntimeError, match="stray"):
        other.resume("ref_1_test.pt")
