"""The port's predict CLI (``sd_video_gen_tpu_torch/predict/predict.py``
``main``, ``--device cpu``) against the JAX package's on the same
reference-layout ``.pt`` and the same bouncing-ball clips.

Tolerance: the PNGs the two write with ``--save_output`` agree within one
uint8 level (f32 on both sides; a value on a rounding boundary may take the
other level), and at most 1% of the pixels differ at all.
"""

import json
import os

import numpy as np
import pytest
import torch

from sd_video_gen_tpu.predict import predict as JP
from sd_video_gen_tpu_torch.data import generate_bouncing_ball_tree
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.predict import predict as P
from sd_video_gen_tpu_torch.train import trainer as T

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
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tcfg.yml").write_text(YAML)
    generate_bouncing_ball_tree(str(tmp_path / "ball"), 2, 2, 10, 32, seed=0)
    # a reference-layout .pt: the port's names plus the positional buffer
    # the reference saves
    mc = FrameTransformerConfig(latent_dim=64, dim_model=32, num_heads=4,
                                num_encoder_layers=1, num_decoder_layers=1,
                                frames_to_predict=2)
    m = build(FrameTransformer, mc, "cpu", seed=4)
    sd = dict(m.state_dict(),
              **{"positional_encoder.pos_encoding": torch.zeros(64, 1, 32)})
    torch.save(sd, tmp_path / "ref.pt")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _argv(d, *extra, cpu=True):
    return ["--dataset", "ball", "--config", "tcfg", "--config_dir",
            str(d / "configs"), "--folder", str(d / "ball"),
            "--pred_frames", "3", "--max_clips", "3", "--batch_clips", "2",
            *extra] + (["--device", "cpu"] if cpu else [])


def _run_in(d, sub, main, argv):
    os.makedirs(d / sub, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d / sub)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


def _pngs(root):
    import cv2
    out = {}
    for n in sorted(os.listdir(root)):
        for f in sorted(os.listdir(os.path.join(root, n))):
            out[(n, f)] = cv2.imread(os.path.join(root, n, f))
    return out


@pytest.mark.parametrize("extra", [[], ["--rollout", "cached"],
                                   ["--train_mode", "diff"]])
def test_main_writes_the_jax_clis_frames(run_dir, extra, capsys):
    argv = _argv(run_dir, "--torch_checkpoint", str(run_dir / "ref.pt"),
                 "--save_output", "True", "--timing", *extra)
    _run_in(run_dir, "jax", JP.main, argv[:-2])
    jax_out = capsys.readouterr().out
    _run_in(run_dir, "port", P.main, argv)
    port_out = capsys.readouterr().out
    a, b = _pngs(run_dir / "jax" / "outputs"), _pngs(run_dir / "port" /
                                                     "outputs")
    assert set(a) == set(b) and len(a) == 3 * 7       # 3 clips, 4 + 3 frames
    diff = np.concatenate([np.abs(a[k].astype(int) - b[k].astype(int))
                           .ravel() for k in a])
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    # predicted frames carry the red border, context frames do not
    assert tuple(b[("0", "6.png")][0, 0]) == (0, 0, 255)
    assert b[("0", "6.png")].shape == (34, 34, 3)
    assert b[("0", "0.png")].shape == (32, 32, 3)
    t_jax, t_port = (json.loads([ln for ln in out.splitlines()
                                 if ln.startswith("{")][-1])
                     for out in (jax_out, port_out))
    assert set(t_port) == set(t_jax)
    assert set(t_port["stage_s"]) == set(t_jax["stage_s"])
    assert t_port["clips"] == 3 and t_port["batches"] == 2
    assert 0 < t_port["first_sync_s"] <= t_port["total_s"]


def test_save_frames_does_not_collide(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    img = np.zeros((2, 8, 8, 3), np.uint8)
    os.makedirs("outputs/0")
    os.makedirs("outputs/2")     # a gap at 1: a count of entries collides
    f1 = P.save_frames(img, [False, True])
    f2 = P.save_frames(img, [False, True])
    assert f1 != f2 and not os.path.basename(f1) in ("0", "2")
    assert sorted(os.listdir("outputs")) == sorted(
        ["0", "2", os.path.basename(f1), os.path.basename(f2)])
    assert sorted(os.listdir(f1)) == ["0.png", "1.png"]


def test_naive_diff_is_a_pure_copy(run_dir):
    """--naive with --train_mode diff scores the copy-last-frame control,
    not Identity under the residual add."""
    import cv2
    for mode in ("ar", "diff"):
        P.main(_argv(run_dir, "--naive", "True", "--train_mode", mode,
                     "--max_clips", "1", "--save_output", "True"))
    a, b = (run_dir / "outputs" / d for d in ("0", "1"))
    for f in sorted(os.listdir(a)):
        assert (cv2.imread(str(a / f)) == cv2.imread(str(b / f))).all(), f
    # the predicted frames (inside their border) repeat the last context
    # frame after a pixel-codec round trip
    last, pred = cv2.imread(str(a / "3.png")), cv2.imread(str(a / "5.png"))
    assert pred.shape == (34, 34, 3)
    assert (cv2.imread(str(a / "6.png")) == pred).all()
    assert np.abs(last.astype(int) - pred[1:-1, 1:-1]).mean() < 20


@pytest.mark.parametrize("extra", [
    ["--reference_pe", "--int8", "True"],
    ["--reference_pe", "--rollout", "cached"],
    ["--rollout", "cached", "--naive", "True"],
    ["--int8", "True", "--train_mode", "text"],
    ["--int8", "True", "--naive", "True"]])
def test_the_jax_clis_refusals_stand(run_dir, extra):
    for main in (P.main, JP.main):
        with pytest.raises(SystemExit):
            main(_argv(run_dir, *extra, cpu=main is P.main))
    assert not os.path.exists(run_dir / "outputs")


def test_mesh_raises_before_anything_is_built(run_dir):
    """A mesh that is not the process group (one process here) is refused
    before anything is built (``test_torch_tensor_parallel.py`` runs the
    mesh)."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1.*torchrun"):
        P.main(_argv(run_dir, "--mesh", "data=2"))
    assert not os.path.exists(run_dir / "outputs")


def test_the_cli_needs_a_card_unless_the_cpu_is_asked_for(run_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(_argv(run_dir, "--naive", "True", cpu=False))


def test_a_checkpoint_directory_written_by_the_trainer_is_read_back(
        run_dir, capsys):
    """Train one epoch with the port's trainer, then serve its checkpoint
    directory: the model holds the trained parameters."""
    argv = _argv(run_dir)[:6] + ["--folder", str(run_dir / "ball"),
                                 "--debug", "True", "--device", "cpu"]
    T.main(argv)
    assert os.path.isdir(run_dir / "checkpoints" / "tcfg_0_test")
    args = P.build_predict_parser().parse_args(_argv(run_dir))
    from sd_video_gen_tpu_torch.config import load_config
    cfg = load_config("tcfg", str(run_dir / "configs"))
    model = P.build_model(cfg, args, "cpu")
    saved = torch.load(run_dir / "checkpoints" / "tcfg_0_test" / "state.pt",
                       weights_only=True)["params"]
    got = model.state_dict()
    assert set(saved) == set(got)
    assert all(torch.equal(saved[k], got[k]) for k in saved)
    P.main(_argv(run_dir, "--max_clips", "2"))
    assert "predicted 3 frames for 2 clips" in capsys.readouterr().out


def test_a_reference_pt_in_the_checkpoint_directory_is_picked_up(run_dir):
    os.makedirs(run_dir / "checkpoints")
    os.replace(run_dir / "ref.pt", run_dir / "checkpoints" / "tcfg_0_test.pt")
    args = P.build_predict_parser().parse_args(_argv(run_dir))
    from sd_video_gen_tpu_torch.config import load_config
    model = P.build_model(load_config("tcfg", str(run_dir / "configs")),
                          args, "cpu")
    sd = torch.load(run_dir / "checkpoints" / "tcfg_0_test.pt",
                    weights_only=True)
    assert torch.equal(model.out.weight, sd["out.weight"])
    # a .pt of other widths is refused, not half-loaded
    torch.save({k: v[..., :1] if k == "out.weight" else v
                for k, v in sd.items()},
               run_dir / "checkpoints" / "tcfg_0_test.pt")
    with pytest.raises(ValueError, match="shape mismatches"):
        P.build_model(load_config("tcfg", str(run_dir / "configs")), args,
                      "cpu")
