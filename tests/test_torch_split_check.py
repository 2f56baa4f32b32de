"""``tools/split_check.py`` on the CPU at a small size: the mean of a
batch's slice gradients and the reversed batch's gradient each sit within
f32 rounding of the whole batch's, tensor by tensor, and the report names
the worst tensors. On the card it runs ``train_flagship``'s model in f32 on
24 clips in 4 slices."""
import numpy as np
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


def test_the_f64_reference_reads_every_run_against_the_exact_gradient():
    """``--reference f64``: the whole batch, the mean of its slices and the
    reversed batch are each within f32 rounding of the f64 gradient (the
    tiny model is well conditioned), over all tensors and per tensor, and
    so are their loss components; the key biases' thirds stay out of the
    per-tensor readings."""
    batch = S.clips("square", 8, 5, 16)
    out = S.check(CFG, batch, 4, torch.device("cpu"), top=3,
                  reference="f64")["f64"]
    for run in ("whole", "split", "order"):
        assert 0 < out[f"all_{run}_rel_l2"] < 1e-5
        assert 0 < out[f"max_{run}_rel_l2"] < 1e-4
        loss = out[f"{run}_loss_rel"]
        assert set(loss) == {"mse", "gdl", "contrastive", "total"}
        assert max(loss.values()) < 1e-5
    rows = out["worst"] + out["worst_ratio"]
    assert len(out["worst"]) == 3 and all(
        not r["tensor"].endswith("in_proj_bias[k]") for r in rows)
    assert out["worst_ratio"][0]["ratio"] >= 1.0


def test_a_key_bias_has_no_exact_gradient():
    """A key bias adds a constant to a query's logits, which the softmax
    ignores: in f64 its gradient is ~1e-16 of the query bias's; in f32 it
    is rounding alone, far above that."""
    batch = S.clips("noise", 4, 5, 16)
    model, codec, loss_w, k = S._model(CFG, torch.device("cpu"), 0)
    g64, _ = S.gradients(model.double(), codec, loss_w, k, batch,
                         torch.float64)
    for name, g in g64.items():
        if name.endswith("in_proj_bias"):
            q, key, _ = g.chunk(3)
            assert key.norm() < 1e-12 * q.norm()


def test_an_f64_model_computes_in_f64():
    """``ops/losses.wide``: bf16 and f32 become f32, f64 stays; so the
    FrameTransformer and the losses run in f64 where the model is."""
    from sd_video_gen_tpu_torch.ops.losses import wide
    assert wide(torch.ones(1, dtype=torch.bfloat16)).dtype == torch.float32
    assert wide(torch.ones(1)).dtype == torch.float32
    assert wide(torch.ones(1, dtype=torch.float64)).dtype == torch.float64
    model, codec, loss_w, k = S._model(CFG, torch.device("cpu"), 0)
    _, comps = S.gradients(model.double(), codec, loss_w, k,
                           S.clips("square", 2, 5, 16), torch.float64)
    _, comps32 = S.gradients(model.float(), codec, loss_w, k,
                             S.clips("square", 2, 5, 16))
    assert all(abs(comps[n] - comps32[n]) <= 1e-5 * abs(comps[n])
               for n in comps)


def test_products_at_both_shapes_are_within_f32_of_f64():
    """``--products``: every product of the step at the whole batch's and
    at one slice's shapes, forward and the gradient of its output, against
    f64 on the slice's rows."""
    out = S.products(CFG, S.clips("noise", 8, 5, 16), 4,
                     torch.device("cpu"), top=2)
    assert out["rows"] == 2 and out["products"] > 10
    for part in ("forward", "backward"):
        assert 0 < max(out[f"{part}_max"].values()) < 1e-5
        assert len(out[f"{part}_worst"]) == 2
        assert {"whole", "slice", "product", "index"} <= set(
            out[f"{part}_worst_ratio"][0])


def test_a_sliced_step_takes_the_mean_of_its_slices_gradients():
    """``sliced_step(..., 4)`` at dropout 0, on the trainer's state: Adam's
    first moment after one step is 0.1 times the mean of the 4 slices'
    gradients, the components are the slices' mean, and the parameters
    move as the trainer's own step moves them on that gradient."""
    from sd_video_gen_tpu_torch.train.optim import Adam
    from sd_video_gen_tpu_torch.train.trainer import make_train_step
    batch = S.clips("noise", 8, 5, 16)
    model, codec, loss_w, k = S._model(CFG, torch.device("cpu"), 0)
    want, want_l = None, None
    for part in np.split(batch, 4):
        g, l_ = S.gradients(model, codec, loss_w, k, part)
        want = g if want is None else {n: want[n] + v for n, v in g.items()}
        want_l = l_ if want_l is None else {n: want_l[n] + v
                                            for n, v in l_.items()}
    cfg = CFG.replace(dropout_p=0.0)
    init, _ = make_train_step(model, codec, loss_w, cfg)
    state = init()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, comps = S.sliced_step(model, codec, loss_w, cfg, 4)(state,
                                                               batch, 0)
    assert state.step == 1
    for n, g in want.items():
        assert S._rel(state.opt_state["mu"][n], 0.1 * g / 4) < 1e-6, n
    for n, v in want_l.items():
        assert abs(float(comps[n]) - v / 4) <= 1e-6 * abs(v / 4)
    moved = {n: p.clone() for n, p in before.items()}
    opt = Adam(cfg.lr)
    opt.update(moved, {n: g / 4 for n, g in want.items()},
               opt.init(moved), 1)
    for n, p in state.params.items():
        assert S._rel(p.detach(), moved[n]) < 1e-6, n
