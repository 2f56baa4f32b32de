"""The port's ``Trainer`` and its CLI on the CPU (``--device cpu``): a tiny
FrameTransformer on a generated bouncing-ball tree, through ``main([...])``
as ``python -m sd_video_gen_tpu_torch.train.trainer`` runs it.

Tolerance: none needed; the checks are on the loss falling, file names, the
saved step and exact equality of a run trained from a latent cache with the
run on the frames the cache was made from.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from sd_video_gen_tpu_torch.config import load_config
from sd_video_gen_tpu_torch.data import (BatchLoader, BouncingBallDataset,
                                         generate_bouncing_ball_tree)
from sd_video_gen_tpu_torch.train import checkpoint as ckpt
from sd_video_gen_tpu_torch.train import trainer as T
from sd_video_gen_tpu_torch.utils import preprocess

YAML = """LR: [0.001]
BATCH_SIZE: [2]
EPOCHS: [{epochs}]
FRAMES_PER_CLIP: [3]
FRAMES_TO_PREDICT: [2]
FRAME_SIZE: 32
DIM_MODEL: [32]
NUM_HEADS: [4]
NUM_ENCODER_LAYERS: [1]
NUM_DECODER_LAYERS: [1]
DROPOUT_P: [0.1]
USE_CONTRASTIVE: [{contrastive}]
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "tiny.yml").write_text(
        YAML.format(epochs=2, contrastive=True))
    (tmp_path / "cfgs" / "long.yml").write_text(
        YAML.format(epochs=3, contrastive=False))
    generate_bouncing_ball_tree(str(tmp_path / "balls"), 4, 2, 9, 32, seed=0)
    return tmp_path


def _argv(run_dir, *extra, config="tiny"):
    return ["--dataset", "ball", "--config", config, "--config_dir",
            str(run_dir / "cfgs"), "--folder", str(run_dir / "balls"),
            "--checkpoint_dir", str(run_dir / "ck"), "--debug", "True",
            "--device", "cpu", *extra]


def _log(run_dir, name):
    with open(run_dir / "logs" / f"{name}.jsonl") as f:
        return [json.loads(line) for line in f]


def test_main_trains_two_epochs_and_resumes(run_dir):
    T.main(_argv(run_dir))
    recs = _log(run_dir, "tiny_0")
    assert recs[0]["event"] == "init" and recs[0]["n_params"] > 1e5
    epochs = [r for r in recs if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert epochs[1]["train_loss"] < epochs[0]["train_loss"]
    assert epochs[1]["val_loss"] < epochs[0]["val_loss"]
    assert {"mse_train", "gdl_train", "contrastive_train", "total_train",
            "mse_val", "total_val", "step_ms_mean", "steps_timed"} <= \
        set(epochs[0])
    # 4 sequences of 9 frames -> 12 clips of 3 -> 6 batches an epoch
    assert epochs[0]["steps_timed"] == 6 and epochs[1]["step"] == 12
    path = run_dir / "ck" / "tiny_0_test"
    assert sorted(os.listdir(run_dir / "ck")) == ["tiny_0_test"]
    assert ckpt.read_format_version(str(path)) == 2
    saved = torch.load(path / "state.pt", weights_only=True)
    assert saved["step"] == 12

    T.main(_argv(run_dir, "--resume", "True", "--old_name", "tiny_0_test"))
    recs = _log(run_dir, "tiny_1")           # the index counts checkpoints
    resumed = [r for r in recs if "epoch" in r]
    assert [r["step"] for r in resumed] == [18, 24]
    assert resumed[0]["train_loss"] < epochs[1]["train_loss"] * 1.5
    assert sorted(os.listdir(run_dir / "ck")) == ["tiny_0_test",
                                                  "tiny_1_test"]


def test_the_cli_needs_a_card_unless_the_cpu_is_asked_for(run_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    argv = [a for a in _argv(run_dir) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(argv)


# (--fvd_every, --vae_weights, --multihost, --native_cache and --dataset ucf*
# were refused here until each was ported, and so was a mesh with a model
# axis until tensor parallelism was; its id is kept: in one process the
# two-process mesh is refused at argument time)
@pytest.mark.parametrize("extra,match", [
    pytest.param(["--mesh", "data=1,model=2"],
                 "needs 2 devices, have 1.*torchrun",
                 id="extra1---mesh.*parallel")])
def test_unported_flags_raise_at_argument_time(run_dir, extra, match):
    with pytest.raises(ValueError, match=match):
        T.main(_argv(run_dir, *extra))
    assert not os.path.exists(run_dir / "logs")      # nothing was built
    assert not os.path.exists(run_dir / "ck")


def test_fit_and_trainer_refuse_unported_features_too(run_dir):
    cfg = load_config("tiny", str(run_dir / "cfgs"))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        T.Trainer(cfg, type("A", (), {"mesh": "data=1,model=2"})(),
                  device="cpu", use_wandb=False,
                  checkpoint_dir=str(run_dir / "ck"))
    # ucf* reaches UCF101Dataset.from_args, which names an unknown variant
    with pytest.raises(ValueError, match="Invalid dataset name ucf_nope"):
        T.build_dataset(cfg, type("A", (), {"dataset": "ucf_nope",
                                            "folder": None, "seed": 0})(),
                        "train")
    with pytest.raises(ValueError, match="unknown precision"):
        T.Trainer(cfg, device="cpu", precision="fp8")
    with pytest.raises(ValueError, match="unknown dataset"):
        T.build_dataset(cfg, type("A", (), {"dataset": "nope"})(), "train")


def _loaders(run_dir, cfg, val=True):
    kw = dict(num_frames=cfg.frames_per_clip, dir=str(run_dir / "balls"),
              seed=0)
    train = BatchLoader(BouncingBallDataset(stage="train", **kw),
                        cfg.batch_size, seed=0)
    test = BatchLoader(BouncingBallDataset(stage="test", **kw),
                       cfg.batch_size, seed=0)
    return train, (test if val else [])


def test_save_best_writes_on_improvement_only(run_dir):
    cfg = load_config("long", str(run_dir / "cfgs"))
    tr = T.Trainer(cfg, device="cpu", use_wandb=False,
                   checkpoint_dir=str(run_dir / "ck"))
    tr.logger.quiet = True
    saves = []
    real = tr.save
    tr.save = lambda tag, block=True: (saves.append(tag), real(tag, block))[1]
    history = tr.fit(*_loaders(run_dir, cfg), epochs=3, save_best=True,
                     ckpt_every=5)
    assert len(history) == 3
    want, best_t, best_v = [], math.inf, math.inf
    for m in history:
        if m["train_loss"] < best_t:
            best_t = m["train_loss"]
            want.append("train")
        if m["val_loss"] < best_v:
            best_v = m["val_loss"]
            want.append("test")
    assert saves == want and saves[:2] == ["train", "test"]
    assert (tr.best_train, tr.best_val) == (best_t, best_v)
    assert sorted(os.listdir(run_dir / "ck")) == ["long_0_test",
                                                  "long_0_train"]
    assert not ckpt._PENDING                  # fit drained its saves


def test_ckpt_every_and_the_final_epoch(run_dir):
    cfg = load_config("long", str(run_dir / "cfgs"))
    tr = T.Trainer(cfg, device="cpu", use_wandb=False,
                   checkpoint_dir=str(run_dir / "ck"))
    tr.logger.quiet = True
    saves = []
    real = tr.save
    tr.save = lambda tag, block=True: (saves.append((tr.state.step, block)),
                                       real(tag, block))[1]
    tr.fit(*_loaders(run_dir, cfg), epochs=3, ckpt_every=2)
    assert saves == [(12, False), (18, False)]     # epoch 2, and the last


def test_empty_validation_reports_nan_and_never_a_best(run_dir):
    cfg = load_config("tiny", str(run_dir / "cfgs"))
    tr = T.Trainer(cfg, device="cpu", use_wandb=False,
                   checkpoint_dir=str(run_dir / "ck"))
    tr.logger.quiet = True
    train, empty = _loaders(run_dir, cfg, val=False)
    with pytest.warns(UserWarning, match="validation epoch yielded no"):
        history = tr.fit(train, empty, epochs=1, save_best=True)
    assert math.isnan(history[0]["val_loss"])
    assert tr.best_val == math.inf
    assert sorted(os.listdir(run_dir / "ck")) == ["tiny_0_train"]


def test_interrupt_checkpoint_resumes_exactly(run_dir):
    """A loader that fails in its second epoch: ``fit`` saves
    ``<config>_<index>_interrupt`` and re-raises; a fresh Trainer resumed
    from it and run on equals a Trainer that took the same steps in a row."""
    cfg = load_config("tiny", str(run_dir / "cfgs"))
    train, val = _loaders(run_dir, cfg)
    batches = list(train)

    class Failing:
        def __init__(self):
            self.epochs = 0

        def __iter__(self):
            self.epochs += 1
            for i, b in enumerate(batches):
                if self.epochs == 2 and i == 3:
                    raise KeyboardInterrupt
                yield b

    tr = T.Trainer(cfg, device="cpu", use_wandb=False,
                   checkpoint_dir=str(run_dir / "ck"))
    tr.logger.quiet = True
    with pytest.raises(KeyboardInterrupt):
        tr.fit(Failing(), val, epochs=2)
    assert tr.state.step == 9
    path = run_dir / "ck" / "tiny_0_interrupt"
    assert ckpt.read_format_version(str(path)) == 2
    events = [r for r in _log(run_dir, "tiny_0") if r.get("event")
              == "interrupt"]
    assert events[0]["error"] == "KeyboardInterrupt"
    assert events[0]["checkpoint"] == str(path)

    resumed = T.Trainer(cfg, device="cpu", use_wandb=False,
                        checkpoint_dir=str(run_dir / "ck"))
    resumed.logger.quiet = True
    resumed.init_state(seed=3)
    resumed.resume("tiny_0_interrupt")
    straight = T.Trainer(cfg, device="cpu", use_wandb=False,
                         checkpoint_dir=str(run_dir / "ck2"))
    straight.logger.quiet = True
    straight.init_state(seed=0)
    for _, frames in (batches + batches[:3]):
        straight._step_fn(straight.state, frames, 0)
    for _, frames in batches[3:5]:
        a = resumed._step_fn(resumed.state, frames, 0)[1]["total"]
        b = straight._step_fn(straight.state, frames, 0)[1]["total"]
        assert torch.equal(a, b)
    for k, v in straight.state.params.items():
        assert torch.equal(v, resumed.state.params[k])


def test_text_mode_looks_labels_up_on_the_device(run_dir):
    cfg = load_config("tiny", str(run_dir / "cfgs"))
    tr = T.Trainer(cfg, mode="text", device="cpu", use_wandb=False,
                   checkpoint_dir=str(run_dir / "ck"), num_classes=5,
                   model_cfg=T.FrameTransformerConfig.from_config(
                       cfg, mode="text", text_embed_dim=8,
                       dim_feedforward=32))
    tr.logger.quiet = True
    tr.init_state(seed=0)
    emb = tr._texts([[3, 1], [4, 0]])
    assert torch.equal(emb, tr.text_embedder.table[[3, 4]])
    frames = np.zeros((2, 3, 32, 32, 3), np.uint8)
    tr._step_fn(tr.state, frames, 0, emb)
    with pytest.raises(IndexError):
        tr._texts([[5], [0]])


def test_preprocess_cache_then_latent_cache_training(run_dir, capsys):
    """``utils/preprocess`` writes a cache that ``LatentCacheDataset`` reads
    and ``--latent_cache`` trains from (the ``batch.ndim == 3`` branch): the
    same losses, bit for bit, as training on the frames themselves."""
    out = str(run_dir / "cache")
    preprocess.main(_argv(run_dir, "--out", out))
    assert "train: 12 clips" in capsys.readouterr().out
    lat = np.load(os.path.join(out, "train_latents.npy"))
    assert lat.shape == (12, 3, 64) and lat.dtype == np.float32
    with open(os.path.join(out, "train_index.json")) as f:
        assert len(json.load(f)) == 12
    T.main(_argv(run_dir))
    T.main(_argv(run_dir, "--latent_cache", out))
    on_frames = [r for r in _log(run_dir, "tiny_0") if "epoch" in r]
    on_cache = [r for r in _log(run_dir, "tiny_1") if "epoch" in r]
    for a, b in zip(on_frames, on_cache):
        assert a["train_loss"] == b["train_loss"]
        assert a["val_loss"] == b["val_loss"]
    # --vae_weights: the cache is encoded by the file's VAE (a full-size
    # SD VAE file in diffusers' current names, fp16 on disk)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from synthetic_checkpoint import vae_state_dict
    from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
    from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    torch.save({k: torch.from_numpy(v) for k, v in
                vae_state_dict("modern", np.float16, seed=0).items()},
               run_dir / "vae.pt")
    vae_out = str(run_dir / "vae_cache")
    preprocess.main(_argv(run_dir, "--codec", "vae", "--vae_weights",
                          str(run_dir / "vae.pt"), "--out", vae_out))
    cached = np.load(os.path.join(vae_out, "train_latents.npy"))
    cfg = load_config("tiny", str(run_dir / "cfgs"))
    first = T.build_dataset(cfg, T.build_train_parser().parse_args(
        _argv(run_dir)), "train")[0][1]
    with torch.no_grad():
        for path, match in ((str(run_dir / "vae.pt"), True), (None, False)):
            vae = build_from_file(AutoencoderKL, VAEConfig(), "vae", path,
                                  "cpu")
            want = VAECodec(cfg.frame_size, vae).encode_frames(
                torch.from_numpy(first[None])).numpy()[0]
            assert np.array_equal(cached[0], want) == match


def test_vae_codec_trainer_keeps_the_codec_frozen(run_dir):
    from torch_port_common import TINY_VAE
    from sd_video_gen_tpu_torch.models import build
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    cfg = load_config("tiny", str(run_dir / "cfgs")).replace(frame_size=8)
    vae = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu")
    tr = T.Trainer(cfg, codec_kind="vae", vae=vae, device="cpu",
                   use_wandb=False, checkpoint_dir=str(run_dir / "ck"),
                   model_cfg=T.FrameTransformerConfig(
                       latent_dim=64, dim_model=32, num_heads=4,
                       num_encoder_layers=1, num_decoder_layers=1,
                       dim_feedforward=32, frames_to_predict=2))
    tr.logger.quiet = True
    tr.init_state(seed=0)
    assert tr.model.training and all(p.requires_grad
                                     for p in tr.model.parameters())
    before = {k: v.clone() for k, v in vae.state_dict().items()}
    frames = np.random.default_rng(0).integers(0, 256, (2, 3, 8, 8, 3),
                                               dtype=np.uint8)
    a = float(tr._step_fn(tr.state, frames, 0)[1]["total"])
    for _ in range(5):
        b = float(tr._step_fn(tr.state, frames, 0)[1]["total"])
    assert b < a
    assert not vae.training
    assert not any(p.requires_grad for p in vae.parameters())
    assert all(torch.equal(v, vae.state_dict()[k]) for k, v in before.items())
