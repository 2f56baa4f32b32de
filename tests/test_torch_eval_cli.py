"""The port's evaluation CLIs (``sd_video_gen_tpu_torch/evaluation``:
``predict_fvd.main``, ``compute_fvd_from_files``; and
``predict/run_frame_interpolation.regroup_outputs``) against the JAX
package's, on the CPU (``--device cpu``), on one seeded Moving-MNIST-layout
``.npy``, one reference-layout FrameTransformer ``.pt`` and one
``pytorch_i3d``-layout I3D ``.pt`` read by both.

Tolerances: the pixel MSE within 1e-6 relative (uint8 frames that agree
within a level at most on a handful of pixels); FVD within 1e-3 relative
(I3D's logits agree to ~1e-5 of their scale in f32, and four clips' Fréchet
distance amplifies that through the square root of near-singular
covariances); a Fréchet distance recomputed by the JAX package on the
port's own logits within 1e-10 (the same f64 numpy).
"""

import os

import numpy as np
import pytest
import torch

from sd_video_gen_tpu.evaluation import compute_fvd_from_files as JF
from sd_video_gen_tpu.evaluation import predict_fvd as JPF
from sd_video_gen_tpu.evaluation.fvd import frechet_distance as jfrechet
from sd_video_gen_tpu.predict import run_frame_interpolation as JRI
from sd_video_gen_tpu_torch.evaluation import compute_fvd_from_files as PF
from sd_video_gen_tpu_torch.evaluation import predict_fvd as PPF
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.predict import run_frame_interpolation as PRI

MSE_RTOL = 1e-6
FVD_RTOL = 1e-3

YAML = """FRAMES_PER_CLIP:
 - 5
FRAMES_TO_PREDICT:
 - 2
FRAME_SIZE: 64
DIM_MODEL:
 - 32
NUM_HEADS:
 - 4
NUM_ENCODER_LAYERS:
 - 1
NUM_DECODER_LAYERS:
 - 1
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    (d / "configs").mkdir()
    (d / "configs" / "mcfg.yml").write_text(YAML)
    # Moving-MNIST layout (T, N, 64, 64): 20 sequences, 4 in the test split
    rng = np.random.default_rng(0)
    mnist = np.zeros((10, 20, 64, 64), np.uint8)
    for n in range(20):
        y, x = rng.integers(8, 40, 2)
        for t in range(10):
            mnist[t, n, y + t:y + t + 16, x + 2 * t:x + 2 * t + 16] = \
                rng.integers(100, 256)
    np.save(d / "mnist.npy", mnist)
    mc = FrameTransformerConfig(latent_dim=256, dim_model=32, num_heads=4,
                                num_encoder_layers=1, num_decoder_layers=1,
                                frames_to_predict=2)
    m = build(FrameTransformer, mc, "cpu", seed=2)
    torch.save(dict(m.state_dict(), **{
        "positional_encoder.pos_encoding": torch.zeros(64, 1, 32)}),
        d / "ref.pt")
    with pytest.warns(UserWarning):
        i3d = PPF.load_i3d(None, "cpu")
    torch.save(i3d.state_dict(), d / "i3d.pt")
    return d


def _argv(d, *extra):
    return ["--dataset", "mnist", "--folder", str(d / "mnist.npy"),
            "--config", "mcfg", "--config_dir", str(d / "configs"),
            "--torch_checkpoint", str(d / "ref.pt"),
            "--i3d_weights", str(d / "i3d.pt"), "--pred_frames", "4",
            "--batch_clips", "2", "--max_clips", "4", "--fvd_every", "1",
            *extra]


class _Recorder(torch.nn.Module):
    """The I3D, recording every output (real, then generated, per batch)."""

    def __init__(self, i3d):
        super().__init__()
        self.i3d, self.outs = i3d, []

    def forward(self, x):
        out = self.i3d(x)
        self.outs.append(out.numpy())
        return out


@pytest.fixture
def recorded(monkeypatch):
    rec = []
    load = PPF.load_i3d

    def recording_load(path, device=None):
        rec.append(_Recorder(load(path, device)))
        return rec[-1]
    monkeypatch.setattr(PPF, "load_i3d", recording_load)
    return rec


def test_predict_fvd_matches_jax(files, recorded, capsys):
    jfvd, jmse = JPF.main(_argv(files))
    jout = capsys.readouterr().out
    fvd, mse = PPF.main(_argv(files, "--device", "cpu", "--timing"))
    out = capsys.readouterr().out
    assert np.isfinite(fvd) and fvd > 0
    np.testing.assert_allclose(mse, jmse, rtol=MSE_RTOL)
    np.testing.assert_allclose(fvd, jfvd, rtol=FVD_RTOL)
    # every --fvd_every batch, then the final line, as the JAX CLI prints
    assert out.count("FVD so far") == jout.count("FVD so far") == 2
    assert "FVD (streaming, 4 clips)" in out
    walls = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(walls) == 1 and '"i3d_s"' in walls[0]
    # the clips entering I3D: 2 batches x (real, generated) of 2 x 9 frames
    assert [o.shape for o in recorded[0].outs] == [(2, 400)] * 4


def test_batch_lineage_and_naive_on_the_port(files, recorded):
    """--fvd_api batch is the JAX package's Fréchet distance of the logits
    the port computed; --naive runs the copy-last-frame control."""
    mses = []
    for extra in (["--fvd_api", "batch"],
                  ["--fvd_api", "batch", "--naive", "True"]):
        fvd, mse = PPF.main(_argv(files, "--device", "cpu", *extra))
        outs = recorded[-1].outs
        real, gen = np.concatenate(outs[0::2]), np.concatenate(outs[1::2])
        np.testing.assert_allclose(fvd, jfrechet(real, gen), rtol=1e-10)
        assert np.isfinite(mse)
        mses.append(mse)
    # the control copies frames: its MSE differs from the model's
    assert mses[0] != mses[1]


def test_clips_under_nine_frames_are_refused_before_anything_runs(files):
    for main in (PPF.main, JPF.main):
        with pytest.raises(SystemExit):
            main(_argv(files, "--pred_frames", "3"))


def test_mesh_raises(files):
    """A mesh that is not the process group, and a mesh with the batch
    API (its statistics are summed over the data axis), are refused before
    anything is built (``test_torch_tensor_parallel.py`` runs the mesh)."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1.*torchrun"):
        PPF.main(_argv(files, "--mesh", "data=2", "--device", "cpu"))
    with pytest.raises(SystemExit):
        PPF.main(_argv(files, "--mesh", "data=1", "--fvd_api", "batch",
                       "--device", "cpu"))


def _frame_tree(root, rng):
    """Unpadded names (10.png after 9.png), nested directories, a video
    whose length is not a multiple of seq_len, a .jpg."""
    import cv2
    for video, n in (("v_b", 10), ("v_a", 12), ("deep/er/v_c", 5)):
        d = root / video
        d.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(d / f"{i}.png"),
                        rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
    cv2.imwrite(str(root / "v_a" / "12.jpg"),
                rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))


def test_compute_fvd_from_files_matches_jax(tmp_path, monkeypatch, files):
    rng = np.random.default_rng(3)
    for side in ("real", "fake"):
        _frame_tree(tmp_path / side, rng)
    for side in ("real", "fake"):
        ours = PF._load_sequences(str(tmp_path / side), 3, 100, 16)
        ref = JF._load_sequences(str(tmp_path / side), 3, 100, 16)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert ours.tobytes() == ref.tobytes()
    assert ours.shape == (3 + 4 + 1, 3, 16, 16, 3)
    ours = PF._load_sequences(str(tmp_path / "real"), 3, 2, 16)
    assert ours.tobytes() == JF._load_sequences(str(tmp_path / "real"), 3, 2,
                                                16).tobytes()
    order = [os.path.basename(p) for p in PF._sequence_paths(
        str(tmp_path / "real" / "v_a"), 13, 1)[0]]
    assert order == [f"{i}.png" for i in range(12)] + ["12.jpg"]

    # FVD: the JAX package's Fréchet distance on the port's features
    recorded = []
    orig = PF.get_fvd_logits

    def logits(i3d, seqs, batch):
        out = orig(i3d, seqs, batch)
        recorded.append(out.numpy())
        return out
    monkeypatch.setattr(PF, "get_fvd_logits", logits)
    fvd = PF.main(["--real_dir", str(tmp_path / "real"), "--fake_dir",
                   str(tmp_path / "fake"), "--seq_len", "9", "--size", "16",
                   "--batch", "2", "--i3d_weights",
                   str(files / "i3d.pt"), "--device", "cpu"])
    assert len(recorded) == 2 and recorded[0].shape == (2, 400)
    np.testing.assert_allclose(fvd, jfrechet(*recorded), rtol=1e-10)
    with pytest.raises(FileNotFoundError):
        PF.main(["--real_dir", str(tmp_path / "nothing"), "--fake_dir",
                 str(tmp_path / "fake"), "--seq_len", "3", "--i3d_weights",
                 str(files / "i3d.pt"), "--device", "cpu"])


def test_regroup_outputs_matches_jax(tmp_path):
    import cv2
    out = tmp_path / "outputs"
    for n, frames in (("0", 14), ("1", 10), ("10", 13)):
        (out / n).mkdir(parents=True)
        for i in range(frames):
            cv2.imwrite(str(out / n / f"{i}.png"),
                        np.full((4, 4, 3), i, np.uint8))
    (out / "stray.txt").write_text("not a rollout")
    ours = PRI.regroup_outputs(str(out), str(tmp_path / "port"))
    ref = JRI.regroup_outputs(str(out), str(tmp_path / "jax"))
    assert [os.path.relpath(p, tmp_path / "port") for p in ours] == \
        [os.path.relpath(p, tmp_path / "jax") for p in ref] == \
        ["counter_0", "counter_1", "counter_10"]
    for g in ("counter_0", "counter_1", "counter_10"):
        names = sorted(os.listdir(tmp_path / "port" / g))
        assert names == sorted(os.listdir(tmp_path / "jax" / g))
        for f in names:
            assert (tmp_path / "port" / g / f).read_bytes() == \
                (tmp_path / "jax" / g / f).read_bytes()
    assert sorted(os.listdir(tmp_path / "port" / "counter_1")) == \
        ["008.png", "009.png"]
    if PRI.importlib.util.find_spec("frame_interpolation") is None:
        with pytest.raises(ModuleNotFoundError, match="FILM"):
            PRI.run_film(str(tmp_path / "port"))
