"""One TF32 setting for the whole port, off: ``config.strict_f32`` turns
TF32 off for matrix products and cuDNN convolutions, and every entry point
of the port that can reach the card calls it first, so a user's run
computes f32 as the JAX package does and as every card number was measured
(``chip_smoke.py`` calls the same function). On the CPU the flags change no
arithmetic; the tests check that they are set."""

import ast
import os

import pytest
import torch

from sd_video_gen_tpu_torch.config import strict_f32, write_config
from sd_video_gen_tpu_torch.evaluation import predict_fvd
from sd_video_gen_tpu_torch.tools.quality_modes import make_moving_disks
from sd_video_gen_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sd_video_gen_tpu_torch")
ENTRY_POINTS = ["train/trainer.py", "predict/predict.py",
                "evaluation/predict_fvd.py",
                "evaluation/compute_fvd_from_files.py",
                "predict/run_frame_interpolation.py", "utils/preprocess.py",
                "tools/quality_modes.py", "tools/dpmpp_quality_gate.py",
                "examples/ball_demo.py", "examples/serving_demo.py",
                "bench.py", "tools/bench_knee.py", "tools/bench_attention.py",
                "tools/bench_cli_serving.py", "tools/bench_cli_train.py",
                "tools/bench_ucf_loader.py"]
OFF = (False, False, "highest")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads gain little and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _tf32_on():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


@pytest.fixture
def restore_flags():
    saved = _flags()
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     precision) = saved
    torch.set_float32_matmul_precision(precision)


def test_strict_f32_turns_every_tf32_flag_off(restore_flags):
    _tf32_on()
    assert _flags() == (True, True, "high")
    strict_f32()
    assert _flags() == OFF


def test_trainer_and_fvd_cli_runs_leave_tf32_off(restore_flags, tmp_path,
                                                 monkeypatch):
    """A tiny training run and an FVD run of its checkpoint, each started
    with TF32 on."""
    monkeypatch.chdir(tmp_path)
    npy = make_moving_disks(str(tmp_path / "disks.npy"), seqs=10, frames=9,
                            size=32)
    write_config(str(tmp_path / "tiny.yml"), {
        "BATCH_SIZE": [2], "EPOCHS": [1], "FRAMES_PER_CLIP": [5],
        "FRAMES_TO_PREDICT": [4], "FRAME_SIZE": 32, "DIM_MODEL": [32],
        "NUM_HEADS": [2], "NUM_ENCODER_LAYERS": [1],
        "NUM_DECODER_LAYERS": [1]})
    argv = ["--dataset", "mnist", "--folder", npy, "--config", "tiny",
            "--config_dir", str(tmp_path), "--debug", "True", "--device",
            "cpu"]
    _tf32_on()
    trainer.main(argv)
    assert _flags() == OFF
    _tf32_on()
    fvd, mse = predict_fvd.main(argv + ["--pred_frames", "4", "--max_clips",
                                        "2", "--batch_clips", "2"])
    assert _flags() == OFF and mse > 0


@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_every_entry_point_turns_tf32_off_first(path):
    """The first statement of each ``main`` (after its docstring) is
    ``strict_f32()``."""
    with open(os.path.join(PKG, path)) as f:
        tree = ast.parse(f.read())
    main, = (n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = main.body[1:] if ast.get_docstring(main) else main.body
    first = body[0]
    assert (isinstance(first, ast.Expr) and isinstance(first.value, ast.Call)
            and getattr(first.value.func, "id", None) == "strict_f32"), path


def test_chip_smoke_runs_under_the_entry_points_setting():
    """``chip_smoke.py`` (the main process and every tp worker) turns TF32
    off through the same function and sets no flag of its own."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    tree = ast.parse(src)
    calls = {fn.name for fn in tree.body if isinstance(fn, ast.FunctionDef)
             for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "strict_f32"}
    assert calls == {"main", "tp_worker"}
    assert "allow_tf32 = False" not in src
    assert "set_float32_matmul_precision" not in src
