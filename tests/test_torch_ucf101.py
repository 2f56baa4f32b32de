"""The port's UCF-101 dataset (``sd_video_gen_tpu_torch/data/ucf101.py``)
against the JAX package's on the same synthetic .avi tree and split lists,
and the trainer's ``--dataset ucf`` through its CLI on the CPU.

Tolerance: none. Clip index, resample indices, epoch orders and every clip
(flip on, same seed) are equal exactly, bytes included.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import cv2
from sd_video_gen_tpu.data import ucf101 as J

from sd_video_gen_tpu_torch.data import ucf101 as P
from sd_video_gen_tpu_torch.train import trainer as T

CLASSES = ("ApplyLipstick", "WallPushups", "Drumming")


@pytest.fixture(scope="module")
def ucf_tree(tmp_path_factory):
    """3 classes x 3 MJPG videos at 12 fps (24, 30 or 18 frames of 48x36,
    a fill that moves with class, video and frame), the third video of each
    class in the test list (tests/test_ucf101.py's tree, one class more and
    uneven lengths)."""
    tmp = tmp_path_factory.mktemp("ucf")
    data = tmp / "UCF-101"
    names = {}
    for ci, cls in enumerate(CLASSES):
        (data / cls).mkdir(parents=True)
        for vi in range(3):
            name = f"v_{cls}_g{vi:02d}_c01.avi"
            vw = cv2.VideoWriter(str(data / cls / name),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                                 (48, 36))
            for t in range((24, 30, 18)[vi]):
                frame = np.full((36, 48, 3), (ci * 40 + vi * 5 + t * 8) % 240,
                                np.uint8)
                frame[:, : 4 + t % 20] = 255 - frame[:, : 4 + t % 20]
                vw.write(frame)
            vw.release()
            names.setdefault(cls, []).append(f"{cls}/{name}")
    labels = tmp / "splits"
    labels.mkdir()
    with open(labels / "trainlist01.txt", "w") as f:
        for cls, vs in names.items():
            for v in vs[:2]:
                f.write(f"{v} 1\n")
    with open(labels / "testlist01.txt", "w") as f:
        for cls, vs in names.items():
            f.write(f"{vs[2]}\n")
    return str(data), str(labels)


def _pair(ucf_tree, **kw):
    data, labels = ucf_tree
    return (J.UCF101Dataset(data, labels, **kw),
            P.UCF101Dataset(data, labels, **kw))


def _same_index(j, p):
    assert p.classes == j.classes and p.class_to_idx == j.class_to_idx
    assert p.items == j.items
    assert p._video_item_ranges == j._video_item_ranges
    assert len(p.videos) == len(j.videos)
    for (pp, pl, pi), (jp, jl, ji) in zip(p.videos, j.videos):
        assert (pp, pl) == (jp, jl)
        np.testing.assert_array_equal(pi, ji)
        assert pi.dtype == ji.dtype


@pytest.mark.parametrize("train,rate,fpc,cap", [
    (True, 6, 4, None),        # integer step 2: all sliding windows
    (True, 5, 3, 2),           # fractional step 2.4, 2 clips a video
    (False, None, 5, None),    # native rate
    (False, 4, 2, None)])      # integer step 3
def test_clip_index_matches_jax(ucf_tree, train, rate, fpc, cap):
    j, p = _pair(ucf_tree, frames_per_clip=fpc, train=train, frame_rate=rate,
                 frame_size=32, clips_per_video=cap)
    _same_index(j, p)
    assert len(p) == len(j) > 0


@pytest.mark.parametrize("sampling", ["grouped", "clip"])
def test_epoch_order_matches_jax(ucf_tree, sampling):
    j, p = _pair(ucf_tree, frames_per_clip=4, frame_rate=6, frame_size=32,
                 sampling=sampling)
    rj, rp = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        oj, op = j.epoch_order(rj), p.epoch_order(rp)
        np.testing.assert_array_equal(op, oj)
        assert sorted(op.tolist()) == list(range(len(p)))


@pytest.mark.parametrize("cache_videos", [1, 32])
def test_every_clip_matches_jax_byte_for_byte(ucf_tree, cache_videos):
    """Flip on, the same seed: the same coins, the same decoded, resampled,
    nearest-resized bytes, in a grouped epoch order and again in a shuffled
    one (with one cached video the LRU evicts on every change of video)."""
    j, p = _pair(ucf_tree, frames_per_clip=4, frame_rate=5, frame_size=24,
                 flip=True, seed=3, cache_videos=cache_videos)
    flipped = 0
    for order in (p.epoch_order(np.random.default_rng(0)),
                  np.random.default_rng(1).permutation(len(p))):
        for i in order:
            (lj, cj), (lp, cp) = j[int(i)], p[int(i)]
            assert lp == lj and len(lp) == 4
            assert cp.dtype == np.uint8 and cp.shape == (4, 24, 24, 3)
            assert cp.flags.c_contiguous
            np.testing.assert_array_equal(cp, cj)
            flipped += not np.array_equal(cp, p._frames_for_video(
                p.items[int(i)][0])[p.items[int(i)][1]:][:4])
    assert 0 < flipped < 2 * len(p)      # the coin fell both ways
    assert len(p._cache) <= cache_videos


@pytest.mark.parametrize("stage", ["train", "test"])
@pytest.mark.parametrize("mode", ["ar", "future", "learned_tgt"])
def test_from_args_matches_jax(ucf_tree, stage, mode):
    data, labels = ucf_tree
    cfg = SimpleNamespace(frames_per_clip=3, frames_to_predict=2, fps=6,
                          frame_size=16)
    args = SimpleNamespace(folder=data, dataset="ucf", ucf_labels=labels,
                           train_mode=mode, flip=True, seed=2)
    j = J.UCF101Dataset.from_args(cfg, args, stage)
    p = P.UCF101Dataset.from_args(cfg, args, stage)
    _same_index(j, p)
    assert p.frames_per_clip == j.frames_per_clip == (3 if mode == "ar"
                                                      else 5)
    assert p.flip == j.flip == (stage == "train")
    assert (p.frame_rate, p.frame_size) == (6, 16)
    for i in range(len(p)):
        np.testing.assert_array_equal(p[i][1], j[i][1])
    pinned = P.UCF101Dataset.from_args(cfg, args, stage, exact_frames=4)
    assert pinned.frames_per_clip == 4


@pytest.mark.parametrize("dataset", ["ucf", "ucf_wallpushups", "ucf_workout",
                                     "ucf_instruments", "ucf_nope"])
def test_from_args_directory_dispatch_matches_jax(dataset, tmp_path,
                                                  monkeypatch):
    """Without --folder the variant names its directory under data/UCF-101,
    as in the reference; an unknown variant raises the same error."""
    monkeypatch.chdir(tmp_path)
    seen = {}

    def recorder(name):
        def record(self, data_dir, label_dir, **kw):
            seen.setdefault(name, []).append((data_dir, label_dir, kw))
        return record

    for mod in (J, P):
        monkeypatch.setattr(mod.UCF101Dataset, "__init__",
                            recorder(mod.__name__))
    cfg = SimpleNamespace(frames_per_clip=5, frames_to_predict=5, fps=3,
                          frame_size=128)
    args = SimpleNamespace(folder=None, dataset=dataset, seed=0)
    outs = []
    for mod in (J, P):
        try:
            mod.UCF101Dataset.from_args(cfg, args, "train")
            outs.append(None)
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    assert (outs[1] is not None) == (dataset == "ucf_nope")
    assert seen.get(J.__name__) == seen.get(P.__name__)
    assert (J.__name__ in seen) == (dataset != "ucf_nope")


@settings(max_examples=150, deadline=None)
@given(total=st.integers(0, 400), orig=st.sampled_from(
    [0.0, 7.5, 12.0, 23.976, 25.0, 29.97, 30.0, 60.0]),
    new=st.sampled_from([None, 1, 2, 3, 4, 5, 6, 7.5, 10, 12, 15, 30]))
def test_resample_indices_matches_jax(total, orig, new):
    got, want = P.resample_indices(total, orig, new), \
        J.resample_indices(total, orig, new)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@settings(max_examples=150, deadline=None)
@given(n=st.integers(0, 200), size=st.integers(1, 20),
       step=st.integers(1, 7))
def test_clip_starts_matches_jax(n, size, step):
    got, want = P.clip_starts(n, size, step), J.clip_starts(n, size, step)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_find_classes_and_split_lists_match_jax(ucf_tree):
    data, labels = ucf_tree
    assert P.find_classes(data) == J.find_classes(data) == sorted(CLASSES)
    for train in (True, False):
        assert P._read_split_videos(labels, train) == \
            J._read_split_videos(labels, train)


def test_trainer_cli_trains_on_ucf(ucf_tree, tmp_path, monkeypatch):
    """``--dataset ucf --folder <tree> --ucf_labels <lists>`` through the
    port's ``train.trainer.main`` on the CPU: one epoch of the clips the
    dataset gives, a checkpoint written; and ``--train_mode text`` takes
    the class ids of the batches to the embedder."""
    data, labels = ucf_tree
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    (tmp_path / "ucf_tiny.yml").write_text(json.dumps({
        "LR": [1e-3], "BATCH_SIZE": [2], "EPOCHS": [1], "FRAMES_PER_CLIP": [3],
        "FRAMES_TO_PREDICT": [2], "FPS": [6], "FRAME_SIZE": 16,
        "DIM_MODEL": [32], "NUM_HEADS": [4], "NUM_ENCODER_LAYERS": [1],
        "NUM_DECODER_LAYERS": [1], "USE_CONTRASTIVE": [False]}))
    argv = ["--dataset", "ucf", "--folder", data, "--ucf_labels", labels,
            "--config", "ucf_tiny", "--config_dir", str(tmp_path),
            "--checkpoint_dir", str(tmp_path / "ck"), "--debug", "True",
            "--device", "cpu", "--flip", "True"]
    seen = []
    real = T.Trainer._texts
    monkeypatch.setattr(T.Trainer, "_texts", lambda self, indices: (
        seen.append(indices), real(self, indices))[1])
    (hist,) = T.main(argv)
    # the dataset's own clip count decides the steps (batch 2, drop_last)
    n_train = len(P.UCF101Dataset(data, labels, frames_per_clip=3,
                                  frame_rate=6, frame_size=16))
    assert hist[0]["steps_timed"] == n_train // 2
    assert np.isfinite(hist[0]["train_loss"]) and \
        np.isfinite(hist[0]["val_loss"])
    assert os.path.isdir(tmp_path / "ck" / "ucf_tiny_0_test")
    (hist,) = T.main(argv + ["--train_mode", "text"])
    labels_seen = [lab for batch in seen for lab in batch]
    assert labels_seen and all(lab == [lab[0]] * 3 for lab in labels_seen)
    assert {lab[0] for lab in labels_seen} <= {0, 1, 2}
    assert np.isfinite(hist[0]["train_loss"])
