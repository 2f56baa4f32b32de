"""``tools/split_check.py`` on the CPU at a small size: the mean of a
batch's slice gradients and the reversed batch's gradient each sit within
f32 rounding of the whole batch's, tensor by tensor, and the report names
the worst tensors. On the card it runs ``train_flagship``'s model in f32 on
24 clips in 4 slices."""
import pytest
import torch

from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.tools import split_check as S

CFG = Config(lr=1e-5, batch_size=8, frames_per_clip=3, frames_to_predict=2,
             frame_size=16, dim_model=32, num_heads=4, num_encoder_layers=1,
             num_decoder_layers=1, dropout_p=0.1, use_mse=True, use_gdl=True,
             use_contrastive=True, lambda_contrastive=0.025)


@pytest.mark.parametrize("kind", ["square", "noise"])
def test_split_and_reordered_gradients_are_the_whole_batchs(kind):
    batch = S.clips(kind, 8, 5, 16)
    assert batch.shape == (8, 5, 16, 16, 3) and batch.any()
    out = S.check(CFG, batch, 4, torch.device("cpu"), top=3)
    assert out["clips"] == 8 and out["slices"] == 4
    assert len(out["worst"]) == 3
    assert out["worst"][0]["split_rel_l2"] == out["max_split_rel_l2"]
    assert 0 < out["max_split_rel_l2"] < 1e-4
    assert 0 < out["max_order_rel_l2"] < 1e-4


def test_a_batch_that_does_not_split_is_refused():
    with pytest.raises(ValueError, match="do not split"):
        S.check(CFG, S.clips("noise", 6, 5, 16), 4, torch.device("cpu"))
