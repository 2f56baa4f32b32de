"""The port's video helpers and split tool (``utils/video.py``,
``utils/format_data.py``) against the JAX package's.

Tolerance: none for what both packages compute alike (decoded frames of the
same file, HTML, file moves). A round trip through a lossy codec is held
to a mean absolute error of 8 levels of 255 (flat frames; mp4v and DIVX).
"""

import os

import numpy as np
import pytest

from sd_video_gen_tpu.utils import format_data as JF
from sd_video_gen_tpu.utils import video as JV

from sd_video_gen_tpu_torch.utils import format_data as PF
from sd_video_gen_tpu_torch.utils import video as PV


def _frames(n=6, h=24, w=32):
    """Flat BGR frames whose value steps with time: what a codec keeps."""
    return [np.full((h, w, 3), (30 + 35 * t, 200 - 20 * t, 90), np.uint8)
            for t in range(n)]


@pytest.mark.parametrize("ext", ["mp4", "avi"])
def test_video_round_trip_matches_jax(tmp_path, ext):
    frames = _frames()
    p_path = PV.imgs_to_video(frames, str(tmp_path / f"p.{ext}"), fps=10)
    j_path = JV.imgs_to_video(frames, str(tmp_path / f"j.{ext}"), fps=10)
    assert p_path == str(tmp_path / f"p.{ext}")
    assert (tmp_path / f"p.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()
    got = PV.video_to_imgs(p_path)
    np.testing.assert_array_equal(got, JV.video_to_imgs(j_path))
    assert got.shape == (6, 24, 32, 3) and got.dtype == np.uint8
    err = np.abs(got.astype(np.int16) - np.stack(frames)).mean()
    assert err <= 8, err
    for n in (0, 1, 4, 100):
        sub = PV.video_to_imgs(p_path, max_frames=n)
        np.testing.assert_array_equal(sub, JV.video_to_imgs(p_path, n))
        assert len(sub) == min(n, 6)
    assert PV.video_to_imgs(p_path, 0).shape == (0, 0, 0, 3)


def test_display_video_matches_jax(tmp_path):
    path = PV.imgs_to_video(_frames(3), str(tmp_path / "v.mp4"))
    html = PV.display_video(path, width=320)
    assert html == JV.display_video(path, width=320)
    assert html.startswith("<video width=320 controls>")


def test_the_two_errors_and_an_empty_list(tmp_path):
    """A writer that cannot open raises instead of writing nothing; a missing
    file raises instead of decoding as an empty video; as in JAX."""
    bad = str(tmp_path / "no_such_dir" / "v.avi")
    for mod in (PV, JV):
        with pytest.raises(RuntimeError, match="VideoWriter could not open"):
            mod.imgs_to_video(_frames(2), bad)
        with pytest.raises(FileNotFoundError):
            mod.video_to_imgs(str(tmp_path / "missing.mp4"))
        with pytest.raises(ValueError, match="empty frame list"):
            mod.imgs_to_video([], str(tmp_path / "e.mp4"))


def _tree(root, n=10):
    for i in range(n):
        os.makedirs(os.path.join(root, f"{i:04d}"))
        open(os.path.join(root, f"{i:04d}", "000.png"), "wb").close()


def _layout(root):
    return {s: sorted(os.listdir(os.path.join(root, s)))
            for s in ("train", "test")}


@pytest.mark.parametrize("ratio,seed", [(0.8, None), (0.8, 3), (0.5, 11),
                                        (0.3, 0)])
def test_split_dataset_makes_the_jax_moves(tmp_path, ratio, seed):
    _tree(tmp_path / "p")
    _tree(tmp_path / "j")
    got = PF.split_dataset(str(tmp_path / "p"), ratio, seed)
    assert got == JF.split_dataset(str(tmp_path / "j"), ratio, seed)
    assert got == (int(10 * ratio), 10 - int(10 * ratio))
    assert _layout(tmp_path / "p") == _layout(tmp_path / "j")
    assert sorted(os.listdir(tmp_path / "p")) == ["test", "train"]
    if seed is None:                   # sorted order: the first go to train
        assert _layout(tmp_path / "p")["train"] == \
            [f"{i:04d}" for i in range(got[0])]


def test_split_cli(tmp_path, capsys):
    _tree(tmp_path)
    PF.main(["--dir", str(tmp_path), "--ratio", "0.7", "--seed", "5"])
    assert capsys.readouterr().out.strip() == \
        "moved 7 sequences to train/, 3 to test/"
    assert [len(v) for v in _layout(tmp_path).values()] == [7, 3]
