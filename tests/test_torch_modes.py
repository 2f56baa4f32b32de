"""The port's other predict modes against the JAX package on the CPU:
FrameTransformer modes 'future', 'learned_tgt' and 'text', the
``IdentityModel`` baseline, ``ClassNameEmbedder`` and text embeddings through
``ar_rollout``.

Tolerance: f32 forwards on both sides with bridged weights, other summation
orders: rtol 1e-4 / atol 1e-5. The embedding tables are built by the same
numpy code from the same seeds: exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.models.identity import IdentityModel as JIdentity
from sd_video_gen_tpu.models import text_embed as JT
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask
from sd_video_gen_tpu.ops.rollout import ar_rollout as jar_rollout
from sd_video_gen_tpu_torch.diffusion.weights import (bridge_state_dict,
                                                      load_jax_params)
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.identity import IdentityModel
from sd_video_gen_tpu_torch.models import text_embed as PT
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops.masks import causal_mask
from sd_video_gen_tpu_torch.ops.rollout import ar_rollout
from torch_port_common import TINY_FT, japply, np_tree, t, transformer_pair

L = 16


def _seq(seed, batch=2, frames=5):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, L)).astype(np.float32)


def test_future_mode_carries_learned_tgt_and_ignores_it():
    jm, params, pm = transformer_pair(L, seed=50, mode="future",
                                      frames_to_predict=3)
    assert pm.learned_tgt.shape == (1, 3, L)
    np.testing.assert_array_equal(pm.learned_tgt.numpy(),
                                  np.asarray(params["params"]["learned_tgt"]))
    x = _seq(51)
    want = japply(jm, params, jnp.asarray(x), jnp.asarray(x))
    with torch.no_grad():
        got = pm(t(x), t(x))
        pm.learned_tgt.add_(1.0)
        again = pm(t(x), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(got, again)


def test_learned_tgt_mode_decodes_its_queries_and_ignores_tgt():
    jm, params, pm = transformer_pair(L, seed=52, mode="learned_tgt",
                                      frames_to_predict=3)
    assert pm.query_pos.shape == (3, L) and pm.norm.weight.shape == (L,)
    x = _seq(53)
    want = japply(jm, params, jnp.asarray(x), jnp.asarray(x))
    with torch.no_grad():
        got = pm(t(x), t(x))
        other_tgt = pm(t(x), torch.zeros(2, 1, L))
    assert got.shape == (2, 3, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(got, other_tgt)


def test_text_mode_concatenates_the_text_embedding_to_every_token():
    jm, params, pm = transformer_pair(L, seed=54, mode="text",
                                      text_embed_dim=8)
    assert pm.cfg.model_width == 40 and not hasattr(pm, "embedding")
    assert pm.project_image_embedding.weight.shape == (32, L)
    assert pm.out.weight.shape == (L, 40) and pm.pos_table.shape == (64, 40)
    rng = np.random.default_rng(55)
    src, tgt = _seq(56), _seq(57, frames=4)
    emb = rng.standard_normal((2, 8)).astype(np.float32)
    want = japply(jm, params, jnp.asarray(src), jnp.asarray(tgt),
                  tgt_mask=jcausal_mask(4), text_embeds=jnp.asarray(emb))
    with torch.no_grad():
        got = pm(t(src), t(tgt), tgt_mask=causal_mask(4), text_embeds=t(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="text mode requires text_embeds"):
        pm(t(src), t(tgt))


def test_text_embeddings_reach_every_step_of_the_rollout():
    jm, params, pm = transformer_pair(L, seed=58, mode="text",
                                      text_embed_dim=8)
    ctx = _seq(59, frames=6)
    emb = np.random.default_rng(60).standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda p, c, e: jar_rollout(
        jm.apply, p, c, pred_frames=3, window=5,
        model_kwargs={"text_embeds": e}))(params, jnp.asarray(ctx),
                                          jnp.asarray(emb))
    with torch.no_grad():
        got = ar_rollout(pm, t(ctx), pred_frames=3, window=5,
                         model_kwargs={"text_embeds": t(emb)})
        other = ar_rollout(pm, t(ctx), pred_frames=3, window=5,
                           model_kwargs={"text_embeds": t(emb) + 1.0})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert not torch.allclose(got, other, atol=1e-3)


@pytest.mark.parametrize("mode,names", [
    ("future", {"learned_tgt"}),
    ("learned_tgt", {"query_pos", "norm.weight", "norm.bias"}),
    ("text", {"project_image_embedding.weight",
              "project_image_embedding.bias"})])
def test_bridge_carries_each_modes_parameters_under_the_reference_names(
        mode, names):
    _, params, pm = transformer_pair(L, seed=61, mode=mode,
                                     frames_to_predict=3, text_embed_dim=8)
    sd = bridge_state_dict("transformer", np_tree(params))
    assert set(sd) == set(pm.state_dict())
    assert names <= set(sd)
    assert ("embedding.weight" in sd) == (mode != "text")
    # exhaustive both ways: an 'ar' model refuses the extra leaves
    ar = build(FrameTransformer, FrameTransformerConfig(latent_dim=L,
                                                        **TINY_FT), "cpu")
    with pytest.raises(ValueError, match="JAX leaves unused|unassigned"):
        load_jax_params(ar, "transformer", np_tree(params))


def test_config_checks_mode_and_width():
    with pytest.raises(ValueError, match="unknown mode"):
        FrameTransformerConfig(latent_dim=L, mode="diff")
    with pytest.raises(ValueError, match=r"dim_model\+text_embed_dim"):
        FrameTransformerConfig(latent_dim=L, dim_model=32, num_heads=4,
                               mode="text", text_embed_dim=6)
    cfg = FrameTransformerConfig(latent_dim=L, mode="text")
    assert cfg.model_width == 2048 + 384 and cfg.model_width // 8 == 304


def test_identity_model_copies_the_last_frame():
    src, tgt = _seq(62), _seq(63, frames=3)
    want = JIdentity().apply({}, jnp.asarray(src), jnp.asarray(tgt))
    got = IdentityModel()(t(src), t(tgt), tgt_mask=None, text_embeds=None)
    assert got.shape == (2, 3, L) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [
    dict(num_classes=7), dict(num_classes=3, names=["WallPushups", "YoYo",
                                                    "PlayingGuitar"]),
    dict(num_classes=4, table=np.arange(24, dtype=np.float32).reshape(4, 6),
         dim=6)])
def test_class_name_embedder_matches_jax(kw):
    kw = dict(dim=12, **kw) if "dim" not in kw else kw
    je, pe = JT.ClassNameEmbedder(**kw), PT.ClassNameEmbedder(device="cpu",
                                                              **kw)
    np.testing.assert_array_equal(pe.table.numpy(), np.asarray(je.table))
    n = pe.table.shape[0]
    labels = [n - 1, 0, 1]
    want = np.asarray(je(jnp.asarray(labels, jnp.int32)))
    for given in (labels, np.asarray(labels), torch.tensor(labels)):
        got = pe(given)
        assert got.shape == (3, pe.dim) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    for bad in ([0, n], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            pe(bad)
        with pytest.raises(IndexError, match="out of range"):
            je(jnp.asarray(bad, jnp.int32))


def test_class_name_embedder_from_npy_and_name_splitting(tmp_path):
    table = np.random.default_rng(64).standard_normal((5, 9)).astype(
        np.float32)
    np.save(tmp_path / "t.npy", table)
    pe = PT.ClassNameEmbedder.from_npy(str(tmp_path / "t.npy"), device="cpu")
    assert pe.dim == 9
    np.testing.assert_array_equal(pe([4]).numpy(), table[4:])
    with pytest.raises(ValueError, match="wide"):
        PT.ClassNameEmbedder(5, dim=8, table=table, device="cpu")
    for name in ("WallPushups", "YoYo", "UCF", "lowercase", "PlayingTabla"):
        assert PT.split_class_name(name) == JT.split_class_name(name)
    np.testing.assert_array_equal(PT._name_embedding("Wall Pushups", 16),
                                  JT._name_embedding("Wall Pushups", 16))
