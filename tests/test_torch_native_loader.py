"""The port's native frame cache and C++ batch loader
(``sd_video_gen_tpu_torch/data/native_loader.py`` over its own copy of
``fastloader.cpp``) against the JAX package's, and the trainer's
``--native_cache`` through its CLI on the CPU.

Tolerance: none. Cache files are equal byte for byte; both loaders yield
equal indices and batches (flips included) epoch after epoch.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from sd_video_gen_tpu.data import native_loader as J
from sd_video_gen_tpu.train.trainer import _LabelMappedLoader as JLabelMapped

from sd_video_gen_tpu_torch.data import (BouncingBallDataset,
                                         generate_bouncing_ball_tree)
from sd_video_gen_tpu_torch.data import native_loader as P
from sd_video_gen_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Labelled:
    """A class dataset: clip i of a ball dataset under class (7 i) % 5."""

    def __init__(self, inner, offset=0):
        self.inner, self.offset = inner, offset

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return [(7 * i + self.offset) % 5] * 3, self.inner[i][1]


class Latents:
    """Flat f32 records (T, L), as a latent cache holds, under string ids
    (no class: the header gets no labels)."""

    def __init__(self, n=10):
        self.data = np.random.default_rng(4).standard_normal(
            (n, 3, 20)).astype(np.float32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return f"{i:04d}", self.data[i]


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """Ball (10 train clips of 3 frames, 16px), labelled and latent caches,
    each written by both packages."""
    tmp = tmp_path_factory.mktemp("native")
    root = generate_bouncing_ball_tree(str(tmp / "balls"), 5, 2, 6, 16,
                                       seed=1)
    ball = {s: BouncingBallDataset(3, 1, root, s, seed=2)
            for s in ("train", "test")}
    sets = {"ball": ball,
            "labelled": {s: Labelled(d, offset=s == "test")
                         for s, d in ball.items()},
            "latent": {"train": Latents(10), "test": Latents(4)}}
    out = {}
    for name, by_stage in sets.items():
        for pkg, mod in (("jax", J), ("port", P)):
            d = str(tmp / f"{name}_{pkg}")
            for stage, ds in by_stage.items():
                mod.build_frame_cache(ds, d, stage)
            out[name, pkg] = d
    out["root"] = root
    out["sets"] = sets
    return out


@pytest.mark.parametrize("name", ["ball", "labelled", "latent"])
def test_cache_files_match_jax_byte_for_byte(caches, name):
    for stage in ("train", "test"):
        for ext in ("bin", "json"):
            with open(os.path.join(caches[name, "jax"],
                                   f"{stage}.{ext}"), "rb") as f:
                want = f.read()
            with open(os.path.join(caches[name, "port"],
                                   f"{stage}.{ext}"), "rb") as f:
                assert f.read() == want, (stage, ext)
    with open(os.path.join(caches[name, "port"], "train.json")) as f:
        hdr = json.load(f)
    ds = caches["sets"][name]["train"]
    assert hdr["n_clips"] == len(ds)
    # ball's ids are frame-number ints, so its header has them too
    assert ("labels" in hdr) == (name != "latent")
    if name != "latent":
        assert hdr["labels"] == [J._scalar_label(ds[i][0])
                                 for i in range(len(ds))]
    data = np.fromfile(os.path.join(caches[name, "port"], "train.bin"),
                       hdr["dtype"]).reshape([-1] + hdr["shape"])
    np.testing.assert_array_equal(data, np.stack([ds[i][1]
                                                  for i in range(len(ds))]))


LOADER_CASES = {
    "plain": dict(batch_size=4, shuffle=False),
    "shuffle_flip": dict(batch_size=3, shuffle=True, flip=True, seed=5),
    "ratio_ragged": dict(batch_size=4, epoch_ratio=0.7, drop_last=False,
                         seed=1),
    "one_thread": dict(batch_size=2, n_threads=1, prefetch=1, flip=True,
                       seed=9),
    "shard0of2": dict(batch_size=4, flip=True, seed=3, process_shard=(0, 2)),
    "shard1of2": dict(batch_size=4, flip=True, seed=3, process_shard=(1, 2)),
    "shard_tail": dict(batch_size=4, drop_last=False, seed=3,
                       process_shard=(1, 2), shard_multiple=2),
}


@pytest.mark.parametrize("name", ["ball", "latent"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match_jax(caches, name, case):
    """Three epochs of each package's loader over its own cache: the same
    lengths, clip indices and batch bytes."""
    kw = LOADER_CASES[case]
    j = J.NativeBatchLoader(caches[name, "jax"], "train", **kw)
    p = P.NativeBatchLoader(caches[name, "port"], "train", **kw)
    try:
        assert len(p) == len(j) > 0
        assert (p.shape, p.dtype, p.n_clips) == (j.shape, j.dtype, j.n_clips)
        for _ in range(3):
            bj, bp = list(j), list(p)
            assert len(bp) == len(bj) == len(p)
            for (ij, fj), (ip, fp) in zip(bj, bp):
                assert ip == ij
                assert fp.dtype == fj.dtype and fp.shape == fj.shape
                np.testing.assert_array_equal(fp, fj)
    finally:
        j.close()
        p.close()


def test_flips_match_the_dataset_and_shards_reassemble(caches):
    """Each served clip is the dataset's clip or its mirror image (flip on),
    both occur; with flip off, the slices of processes (0, 2) and (1, 2)
    put together are the single-process global batches."""
    ds = caches["sets"]["ball"]["train"]
    p = P.NativeBatchLoader(caches["ball", "port"], "train", batch_size=10,
                            shuffle=False, flip=True, seed=0)
    (idx, frames), = list(p)
    mirrored = [not np.array_equal(frames[k], ds[i][1])
                for k, i in enumerate(idx)]
    for k, i in enumerate(idx):
        want = ds[i][1][:, :, ::-1] if mirrored[k] else ds[i][1]
        np.testing.assert_array_equal(frames[k], want)
    assert any(mirrored) and not all(mirrored)
    p.close()
    kw = dict(batch_size=4, seed=6, epoch_ratio=0.9)
    whole = P.NativeBatchLoader(caches["ball", "port"], "train", **kw)
    parts = [P.NativeBatchLoader(caches["ball", "port"], "train",
                                 process_shard=(r, 2), **kw)
             for r in range(2)]
    for _ in range(2):
        for (i, f), (i0, f0), (i1, f1) in zip(whole, *parts):
            assert i0 + i1 == i
            np.testing.assert_array_equal(np.concatenate([f0, f1]), f)


@pytest.mark.parametrize("kw", [
    dict(batch_size=5, process_shard=(0, 2)),
    dict(batch_size=4, process_shard=(2, 2)),
    dict(batch_size=6, shard_multiple=4),
    dict(batch_size=12, process_shard=(0, 4), shard_multiple=6)],
    ids=["uneven", "out_of_range", "mult", "mult_vs_processes"])
def test_shard_checks_match_jax(caches, kw):
    with pytest.raises(ValueError) as want:
        J.NativeBatchLoader(caches["ball", "jax"], "train", **kw)
    with pytest.raises(ValueError) as got:
        P.NativeBatchLoader(caches["ball", "port"], "train", **kw)
    assert str(got.value) == str(want.value)


def test_label_mapped_loader_uses_each_splits_table(caches):
    """Text mode over a native cache: each split's indices go through its
    own clip -> class table, as the JAX trainer's wrapper maps them."""
    for stage in ("train", "test"):
        kw = dict(batch_size=2, seed=4)
        j = JLabelMapped(J.NativeBatchLoader(caches["labelled", "jax"], stage,
                                             **kw))
        raw = P.NativeBatchLoader(caches["labelled", "port"], stage, **kw)
        p = T._LabelMappedLoader(
            P.NativeBatchLoader(caches["labelled", "port"], stage, **kw))
        ds = caches["sets"]["labelled"][stage]
        assert len(p) == len(j) == len(raw)
        for (lj, fj), (lp, fp), (ids, fr) in zip(j, p, raw):
            assert lp == lj == [ds[i][0][0] for i in ids]
            np.testing.assert_array_equal(fp, fj)
            np.testing.assert_array_equal(fp, fr)


def test_library_is_built_from_the_ports_source_into_build_native(
        tmp_path, monkeypatch):
    """The library's home is build/native/ under the repository, its name
    keyed on the source, flags and compiler; a build runs g++ on the port's
    own fastloader.cpp without -march=native and writes nothing under the
    JAX package's native/ (here into a scratch build directory)."""
    assert P.BUILD_DIR == P.Path(REPO) / "build" / "native"
    assert P.SOURCE == P.Path(REPO) / "sd_video_gen_tpu_torch" / "native" \
        / "fastloader.cpp"
    assert P.library_path().parent == P.BUILD_DIR
    assert P.library_path().name.startswith("libfastloader_")
    native = os.path.join(REPO, "native")
    before = {f: os.stat(os.path.join(native, f)).st_mtime_ns
              for f in os.listdir(native)}
    calls = []
    real = subprocess.run
    monkeypatch.setattr(P.subprocess, "run",
                        lambda cmd, **kw: (calls.append(cmd), real(cmd, **kw))[1])
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path / "native_build")
    out = P.build()
    assert out.parent == tmp_path / "native_build" and out.exists()
    assert sorted(os.listdir(tmp_path / "native_build")) == [out.name]
    (compile_cmd,) = [c for c in calls if "-shared" in c]
    assert compile_cmd[0] == "g++" and str(P.SOURCE) in compile_cmd
    assert not any("march" in a for a in compile_cmd)
    assert not any(c[0] == "make" for c in calls)
    assert P.build() == out and len([c for c in calls if "-shared" in c]) == 1
    # the JAX package's own make may run in another test process, writing
    # native/libfastloader.so: that is the only file native/ may gain
    after = {f: os.stat(os.path.join(native, f)).st_mtime_ns
             for f in os.listdir(native)}
    assert {f: t for f, t in after.items() if f != "libfastloader.so"} == \
        {f: t for f, t in before.items() if f != "libfastloader.so"}


def test_cache_cli_matches_jax(caches, tmp_path):
    """``python -m sd_video_gen_tpu_torch.data.native_loader`` (its
    ``main``) writes the caches the JAX package's CLI writes."""
    (tmp_path / "tiny.yml").write_text(json.dumps(
        {"FRAMES_PER_CLIP": [3], "FRAME_SIZE": 16}))
    argv = ["--dataset", "ball", "--folder", caches["root"], "--config",
            "tiny", "--config_dir", str(tmp_path)]
    J.main(argv + ["--out", str(tmp_path / "j")])
    P.main(argv + ["--out", str(tmp_path / "p")])
    for stage in ("train", "test"):
        for ext in ("bin", "json"):
            assert (tmp_path / "p" / f"{stage}.{ext}").read_bytes() == \
                (tmp_path / "j" / f"{stage}.{ext}").read_bytes()


def test_trainer_cli_trains_from_a_native_cache(caches, tmp_path,
                                                monkeypatch):
    """``--native_cache`` through the port's ``train.trainer.main`` on the
    CPU: an epoch of the cache's batches; in text mode the embedder gets
    the header's class of every served clip; a cache without labels is
    refused for text mode."""
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    (tmp_path / "tiny.yml").write_text(json.dumps({
        "LR": [1e-3], "BATCH_SIZE": [2], "EPOCHS": [1], "FRAMES_PER_CLIP": [3],
        "FRAMES_TO_PREDICT": [2], "FRAME_SIZE": 16, "DIM_MODEL": [32],
        "NUM_HEADS": [4], "NUM_ENCODER_LAYERS": [1], "NUM_DECODER_LAYERS": [1],
        "NUM_WORKERS": [2], "USE_CONTRASTIVE": [False]}))
    argv = ["--dataset", "ball", "--config", "tiny", "--config_dir",
            str(tmp_path), "--checkpoint_dir", str(tmp_path / "ck"),
            "--debug", "True", "--device", "cpu", "--flip", "True"]
    (hist,) = T.main(argv + ["--native_cache", caches["ball", "port"]])
    assert hist[0]["steps_timed"] == 5          # 10 clips, batch 2
    assert np.isfinite(hist[0]["train_loss"]) and \
        np.isfinite(hist[0]["val_loss"])
    assert os.path.isdir(tmp_path / "ck" / "tiny_0_test")

    seen = []
    real = T.Trainer._texts
    monkeypatch.setattr(T.Trainer, "_texts", lambda self, indices: (
        seen.append(list(indices)), real(self, indices))[1])
    served = []
    real_iter = P.NativeBatchLoader.__iter__

    def spy(self):
        for ids, frames in real_iter(self):
            served.append((self.labels, list(ids)))
            yield ids, frames
    monkeypatch.setattr(P.NativeBatchLoader, "__iter__", spy)
    (hist,) = T.main(argv + ["--native_cache", caches["labelled", "port"],
                             "--train_mode", "text"])
    assert np.isfinite(hist[0]["train_loss"])
    assert seen == [[table[i] for i in ids] for table, ids in served]
    assert len(seen) == 5 + 2                  # train and val batches
    with pytest.raises(ValueError, match="needs class labels"):
        T.main(argv + ["--native_cache", caches["latent", "port"],
                       "--train_mode", "text"])
