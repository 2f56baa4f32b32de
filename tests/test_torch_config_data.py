"""The port's own copies of the numpy-only modules against the JAX package's:
``config.py`` (every YAML in ``configs/`` loads to an equal ``Config``, the
same sweep grid, a parser with the same flags and defaults) and ``data/``
(the same seed and arguments give the same bouncing-ball tree, clips, epoch
order and batches). ``train/metrics.py`` and ``utils/profiling.py`` ride
along.

Tolerance: none; everything is equal byte for byte.
"""

import dataclasses
import glob
import json
import os
import sys
import warnings

import numpy as np
import pytest

from sd_video_gen_tpu import config as JCfg
from sd_video_gen_tpu import data as JD
from sd_video_gen_tpu.data.latent_cache import LatentCacheDataset as JLatent
from sd_video_gen_tpu_torch import config as PCfg
from sd_video_gen_tpu_torch import data as PD
from sd_video_gen_tpu_torch.data.latent_cache import LatentCacheDataset
from sd_video_gen_tpu_torch.train.metrics import MetricsLogger
from sd_video_gen_tpu_torch.utils.profiling import StepTimer, annotate, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")
CONFIG_NAMES = sorted(os.path.basename(p)[:-4]
                      for p in glob.glob(os.path.join(CONFIG_DIR, "*.yml")))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_every_yaml_loads_to_the_jax_packages_config(name):
    want, jwarn = _quiet(JCfg.load_config, name, CONFIG_DIR)
    got, pwarn = _quiet(PCfg.load_config, name, CONFIG_DIR)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.latent_hw, got.latent_dim) == (want.latent_hw,
                                               want.latent_dim)
    assert pwarn == jwarn
    jgrid, _ = _quiet(JCfg.sweep_grid, name, CONFIG_DIR)
    pgrid, _ = _quiet(PCfg.sweep_grid, name, CONFIG_DIR)
    assert [dataclasses.asdict(c) for c in pgrid] == \
        [dataclasses.asdict(c) for c in jgrid]
    assert _quiet(PCfg.load_raw_config, name, CONFIG_DIR)[0] == \
        _quiet(JCfg.load_raw_config, name, CONFIG_DIR)[0]


def test_there_are_configs_and_a_swept_one(tmp_path):
    assert len(CONFIG_NAMES) >= 50
    (tmp_path / "grid.yml").write_text(
        "LR: [0.1, 0.01]\nDIM_MODEL: [32, 64, 128]\nFRAME_SIZE: 64\n"
        "dim_feedforward: [1]\n")
    jgrid, jwarn = _quiet(JCfg.sweep_grid, "grid", str(tmp_path))
    pgrid, pwarn = _quiet(PCfg.sweep_grid, "grid", str(tmp_path))
    assert len(pgrid) == 6 and pwarn == jwarn and "ignoring" in pwarn[0]
    assert [dataclasses.asdict(c) for c in pgrid] == \
        [dataclasses.asdict(c) for c in jgrid]
    with pytest.raises(FileNotFoundError):
        PCfg.load_config("no_such_config", str(tmp_path))
    cfg = PCfg.Config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JCfg.Config())
    assert cfg.replace(frame_size=64).latent_dim == 256


def test_a_json_config_reads_without_pyyaml(tmp_path, monkeypatch):
    """JSON is YAML's flow subset: read by PyYAML where it is installed and
    as JSON where it is not, to the same grid as the JAX package's."""
    (tmp_path / "flow.yml").write_text(json.dumps(
        {"LR": [0.1, 0.01], "FRAMES_PER_CLIP": [5], "FRAME_SIZE": 64,
         "DIM_MODEL": [2048], "USE_CONTRASTIVE": [False]}))
    want = [dataclasses.asdict(c)
            for c in JCfg.sweep_grid("flow", str(tmp_path))]
    assert [dataclasses.asdict(c)
            for c in PCfg.sweep_grid("flow", str(tmp_path))] == want
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml now fails
    assert [dataclasses.asdict(c)
            for c in PCfg.sweep_grid("flow", str(tmp_path))] == want
    with pytest.raises(ModuleNotFoundError):
        import yaml  # noqa: F401


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required,
                     getattr(a.type, "__name__", a.type), a.choices, a.nargs)
            for a in parser._actions}


def test_parser_has_the_jax_packages_flags_and_defaults():
    assert _actions(PCfg.build_arg_parser()) == \
        _actions(JCfg.build_arg_parser())
    argv = ["--dataset", "ball", "--config", "config_test", "--config_dir",
            CONFIG_DIR, "--save_best", "False", "--resume", "True"]
    (jcfg, jargs), _ = _quiet(JCfg.parse_config_args, argv)
    (pcfg, pargs), _ = _quiet(PCfg.parse_config_args, argv)
    assert vars(pargs) == vars(jargs)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pargs.save_best is False and pargs.resume is True


def test_the_trainers_parser_has_every_flag_of_the_jax_cli():
    """The JAX trainer adds its flags inside ``main``; read them from its
    source, and hold the port's parser to the same names and defaults."""
    import inspect
    import re
    from sd_video_gen_tpu.train import trainer as JT
    from sd_video_gen_tpu_torch.train.trainer import build_train_parser
    flags = re.findall(r'parser\.add_argument\("(--\w+)"',
                       inspect.getsource(JT.main))
    assert len(flags) >= 14
    mine = {s: a for a in build_train_parser()._actions
            for s in a.option_strings}
    assert set(flags) <= set(mine)
    defaults = {"--train_mode": "ar", "--codec": "pixel", "--sweep": False,
                "--fvd_every": 0, "--fvd_protocol": "last_k",
                "--latent_cache": None, "--native_cache": None,
                "--ckpt_every": 1, "--precision": "f32",
                "--multihost": False, "--device": None}
    for flag, default in defaults.items():
        assert mine[flag].default == default, flag
    assert mine["--precision"].choices == ["f32", "bf16", "bf16_full"]
    assert mine["--train_mode"].choices == ["ar", "future", "diff", "text",
                                            "learned_tgt"]


# -- data ---------------------------------------------------------------------

def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def ball_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("balls")
    j = JD.generate_bouncing_ball_tree(str(root / "j"), 3, 2, 12, 32, seed=4)
    p = PD.generate_bouncing_ball_tree(str(root / "p"), 3, 2, 12, 32, seed=4)
    return j, p


def test_bouncing_ball_tree_is_byte_for_byte_the_jax_packages(ball_trees):
    j, p = ball_trees
    want, got = _tree_bytes(j), _tree_bytes(p)
    assert len(want) == 5 * 12 and sorted(got) == sorted(want)
    assert got == want
    with pytest.raises(ValueError, match="3-digit"):
        PD.generate_bouncing_ball_tree(p, frames_per_seq=1000)


def _same_dataset(jds, pds):
    assert len(pds) == len(jds) > 0
    for i in range(len(jds)):
        (jidx, jfr), (pidx, pfr) = jds[i], pds[i]
        assert pidx == jidx
        assert pfr.dtype == jfr.dtype == np.uint8
        np.testing.assert_array_equal(pfr, jfr)


@pytest.mark.parametrize("kw", [
    dict(num_frames=5, stride=1, stage="train", seed=0),
    dict(num_frames=3, stride=2, stage="test", seed=7),
    dict(num_frames=4, stride=3, stage="train", shuffle=False)])
def test_ball_dataset_gives_the_same_clips(ball_trees, kw):
    j, _ = ball_trees                  # one tree: the trees are equal
    jds = JD.BouncingBallDataset(dir=j, **kw)
    pds = PD.BouncingBallDataset(dir=j, **kw)
    assert pds.clips == jds.clips and pds.indices == jds.indices
    _same_dataset(jds, pds)


def test_kitti_dataset_crops_and_resizes_the_same(tmp_path):
    import cv2
    rng = np.random.default_rng(0)
    for seq, (h, w) in enumerate(((20, 36), (30, 24)), start=1):
        d = tmp_path / "train" / f"{seq:04d}"
        d.mkdir(parents=True)
        for t in range(6):
            cv2.imwrite(str(d / f"{seq:04d}{t:03d}.png"),
                        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    kw = dict(num_frames=3, stride=1, dir=str(tmp_path), stage="train",
              frame_size=16, seed=1)
    jds, pds = JD.KittiDataset(**kw), PD.KittiDataset(**kw)
    _same_dataset(jds, pds)
    assert pds[0][1].shape == (3, 16, 16, 3)


def test_moving_mnist_dataset_is_the_same(tmp_path):
    path = str(tmp_path / "mnist.npy")
    np.save(path, np.random.default_rng(0).integers(
        0, 256, (12, 10, 8, 8), dtype=np.uint8))
    for stage in ("train", "test"):
        kw = dict(num_frames=4, stride=2, path=path, stage=stage, seed=2)
        _same_dataset(JD.MovingMNISTDataset(**kw),
                      PD.MovingMNISTDataset(**kw))
    with pytest.raises(ValueError, match="needs"):
        PD.MovingMNISTDataset(num_frames=20, stride=1, path=path)


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, seed=0),
    dict(batch_size=2, seed=3, epoch_ratio=0.5),
    dict(batch_size=4, seed=1, drop_last=False),
    dict(batch_size=2, seed=0, shuffle=False, prefetch=0),
    dict(batch_size=4, seed=5, process_shard=(1, 2)),
    dict(batch_size=4, seed=5, process_shard=(0, 2), shard_multiple=4,
         drop_last=False),
    dict(batch_size=6, seed=2, shard_multiple=2, drop_last=False)])
def test_batch_loader_gives_the_same_epochs(ball_trees, kw):
    j, _ = ball_trees
    ds_kw = dict(num_frames=3, stride=1, dir=j, stage="train", seed=0)
    jl = JD.BatchLoader(JD.BouncingBallDataset(**ds_kw), **kw)
    pl = PD.BatchLoader(PD.BouncingBallDataset(**ds_kw), **kw)
    assert len(pl) == len(jl)
    for _ in range(2):                         # two epochs: the rng moves on
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == len(jl)
        for (jidx, jfr), (pidx, pfr) in zip(jb, pb):
            assert pidx == jidx
            np.testing.assert_array_equal(pfr, jfr)


@pytest.mark.parametrize("kw,match", [
    (dict(batch_size=3, process_shard=(0, 2)), "divide evenly"),
    (dict(batch_size=4, process_shard=(2, 2)), "out of range"),
    (dict(batch_size=4, shard_multiple=3), "multiple of"),
    (dict(batch_size=4, process_shard=(0, 2), shard_multiple=1), None)])
def test_batch_loader_refuses_what_the_jax_one_refuses(kw, match):
    for cls in (JD.BatchLoader, PD.BatchLoader):
        if match is None:
            cls(list(range(8)), **kw)
        else:
            with pytest.raises(ValueError, match=match):
                cls(list(range(8)), **kw)


def test_batch_loader_abandoned_iterator_and_worker_errors(ball_trees):
    j, _ = ball_trees
    ds = PD.BouncingBallDataset(num_frames=3, dir=j, stage="train", seed=0)
    loader = PD.BatchLoader(ds, 2, seed=0)
    first = next(iter(loader))
    assert first[1].shape == (2, 3, 32, 32, 3)

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("unreadable frame")

    with pytest.raises(OSError, match="unreadable"):
        list(PD.BatchLoader(Broken(), 2))


def test_latent_cache_dataset_is_the_same(tmp_path):
    lat = np.random.default_rng(0).standard_normal((5, 3, 16)).astype(
        np.float32)
    np.save(str(tmp_path / "train_latents.npy"), lat)
    for with_index in (False, True):
        if with_index:
            with open(tmp_path / "train_index.json", "w") as f:
                json.dump([[i, i + 1] for i in range(5)], f)
        jds, pds = JLatent(str(tmp_path)), LatentCacheDataset(str(tmp_path))
        assert len(pds) == len(jds) == 5
        for i in range(5):
            assert pds[i][0] == jds[i][0]
            np.testing.assert_array_equal(pds[i][1], jds[i][1])


# -- metrics and profiling ----------------------------------------------------

def test_metrics_logger_writes_jsonl_without_wandb(tmp_path, capsys):
    import torch
    log = MetricsLogger("run", log_dir=str(tmp_path), use_wandb=True)
    assert log._wandb is None          # the package is absent: as the JAX file
    log.log({"loss": torch.tensor(0.5), "event": "x", "n": 3}, step=7)
    log.close()
    rec = json.loads((tmp_path / "run.jsonl").read_text())
    assert rec["loss"] == 0.5 and rec["event"] == "x" and rec["step"] == 7
    assert "[run]" in capsys.readouterr().out
    quiet = MetricsLogger("run", log_dir=str(tmp_path), use_wandb=False,
                          quiet=True)
    quiet.log({"a": 1.0})
    quiet.close()
    assert capsys.readouterr().out == ""
    assert len((tmp_path / "run.jsonl").read_text().splitlines()) == 2


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer()
    assert timer.summary() == {}
    timer.stop()                       # no start: ignored
    for _ in range(20):
        timer.start()
        timer.stop(sync=True)
    s = timer.summary()
    assert s["steps_timed"] == 20
    assert 0 <= s["step_ms_p50"] <= s["step_ms_p95"]
    timer.reset()
    assert timer.summary() == {}
    import torch
    with trace(str(tmp_path / "tr")) as logdir, annotate("region"):
        torch.ones(4).sum()
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
