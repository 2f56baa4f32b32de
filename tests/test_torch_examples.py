"""The port's examples (``sd_video_gen_tpu_torch/examples``) end to end on
the CPU at small sizes: they run, and return what they print."""

import numpy as np
import pytest
import torch

from sd_video_gen_tpu_torch.examples import ball_demo, serving_demo


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads gain little and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ball_demo_trains_and_scores_the_rollout(tmp_path, capsys):
    """``--dataset mnist`` (no cv2 needed): a short run on 32px frames;
    both MSEs finite, the verdict printed."""
    mse_model, mse_naive = ball_demo.main(
        ["--epochs", "1", "--size", "32", "--dataset", "mnist", "--device",
         "cpu", "--data_dir", str(tmp_path)])
    assert np.isfinite(mse_model) and mse_naive > 0
    out = capsys.readouterr().out
    assert "train_loss:" in out and "rollout pixel MSE: model=" in out


@pytest.mark.parametrize("int8", [False, True])
def test_serving_demo_serves_every_stream(capsys, int8):
    out = serving_demo.main(["--device", "cpu", "--rounds", "1", "--frames",
                             "3", "--batch", "2"] + (["--int8"] if int8
                                                     else []))
    assert out.shape == (2 * 3, 64, 64, 3) and out.dtype == torch.uint8
    assert f"int8={int8}" in capsys.readouterr().out


def test_serving_demo_needs_the_config_of_a_checkpoint():
    with pytest.raises(SystemExit):
        serving_demo.main(["--device", "cpu", "--checkpoint", "ck/x_0_test"])
