"""The port's int8 path (``ops/quantized.py``) against the JAX package on the
CPU.

Tolerance: ``quantize_weight`` is elementwise f32 (absmax / 127, a division,
round half to even on both sides): int8 values and scales are exactly equal.
``qdense`` accumulates in int32 on both sides, so given equal int8 weights it
agrees to f32 rounding of the rescale (rtol 1e-6). The whole forward
(``quantized_ar_apply``) sums softmax and layer norm in another order:
rtol 1e-4 / atol 1e-5. A per-token scale that differs in its last bit can
flip one int8 activation by one step, which is worth 1/127 of that token's
largest value in one product: the tests' seeds were checked not to do so.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.ops.cached_rollout import (
    quantize_rollout_params as jquantize_rollout_params)
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask
from sd_video_gen_tpu.ops import quantized as JQ
from sd_video_gen_tpu_torch.diffusion.weights import quantized_tree_from_jax
from sd_video_gen_tpu_torch.ops import quantized as Q
from sd_video_gen_tpu_torch.ops.masks import causal_mask
from torch_port_common import np_tree, t, transformer_pair

L = 16


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("shape,seed", [((16, 48), 0), ((32, 8), 1),
                                        ((48, 96), 2)])
def test_quantize_weight_is_exactly_the_jax_packages(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0                           # a dead channel: scale 1
    want = JQ.quantize_weight(jnp.asarray(w))
    got = Q.quantize_weight(t(w))
    assert got.values.dtype == torch.int8 and got.values.shape == shape
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[3] == 1.0 and not got.values[:, 3].any()
    # column-major: the (out, in) weight's own memory
    assert got.values.t().is_contiguous()


@pytest.mark.parametrize("lead", [(1,), (3,), (2, 5)])
def test_qdense_matches_jax_given_the_same_int8_weights(lead):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal(lead + (32,)).astype(np.float32)
    x[..., :1, :] = 0.0                     # an all-zero token: scale 1
    want = JQ.qdense(jnp.asarray(x), JQ.quantize_weight(jnp.asarray(w)),
                     jnp.asarray(b))
    got = Q.qdense(t(x), Q.quantize_weight(t(w)), t(b))
    assert got.dtype == torch.float32 and got.shape == lead + (24,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    no_bias = Q.qdense(t(x), Q.quantize_weight(t(w)))
    torch.testing.assert_close(no_bias + t(b), got)


def test_int_mm_refuses_what_the_card_cannot_take_instead_of_a_float_product():
    """On the CPU any K works; the CUDA rule (K, N multiples of 8, rows
    padded past 16) is checked on a fake-CUDA flag through the same code."""
    xi = torch.ones((3, 12), dtype=torch.int8)
    w = torch.ones((12, 5), dtype=torch.int8)
    assert torch.equal(Q._int_mm(xi, w), torch.full((3, 5), 12,
                                                    dtype=torch.int32))

    class OnCard(torch.Tensor):
        is_cuda = True
    with pytest.raises(ValueError, match="multiples of 8"):
        Q._int_mm(xi.as_subclass(OnCard), w)
    xi8 = torch.ones((3, 16), dtype=torch.int8).as_subclass(OnCard)
    w8 = torch.ones((16, 8), dtype=torch.int8)
    out = Q._int_mm(xi8, w8)               # 3 rows: padded to 32, sliced back
    assert out.shape == (3, 8) and bool((out == 16).all())


def test_param_tree_holds_views_of_the_models_parameters():
    _, _, pm = transformer_pair(L, seed=30)
    tree = Q.param_tree(pm)
    assert tree["dtype"] == torch.float32
    assert len(tree["enc"]) == 1 and len(tree["dec"]) == 2
    own = {p.data_ptr() for p in pm.parameters()}
    D = pm.cfg.dim_model
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and path[-3:-1] != ("cross_attn",
                                                              "kv"):
            assert leaf.data_ptr() in own, path
    mha = pm.transformer.decoder.layers[0].multihead_attn
    kv = tree["dec"][0]["cross_attn"]["kv"]
    assert kv["weight"].data_ptr() == mha.in_proj_weight[D:].data_ptr()
    assert kv["weight"].shape == (2 * D, D) and kv["bias"].shape == (2 * D,)


def _trees(seed=31):
    jm, params, pm = transformer_pair(L, seed=seed)
    return jm, params, pm, JQ.quantize_frame_transformer(params)


def test_quantize_frame_transformer_equals_the_bridged_jax_tree():
    """Quantising the port's fused rows gives the int8 values and scales of
    the JAX package's separate q / k / v, through either JAX layout."""
    _, params, pm, jq = _trees()
    got = dict(_leaves(Q.quantize_frame_transformer(pm)))
    for jtree in (jq, jquantize_rollout_params(params)):
        want = dict(_leaves(quantized_tree_from_jax(np_tree(jtree))))
        assert set(got) == set(want)
        for path, leaf in want.items():
            if isinstance(leaf, Q.QTensor):
                assert torch.equal(got[path].values, leaf.values), path
                assert torch.equal(got[path].scale, leaf.scale), path
                assert leaf.values.t().is_contiguous()
            elif isinstance(leaf, torch.Tensor):
                assert torch.equal(got[path], leaf), path
            else:
                assert got[path] == leaf, path


def test_bridge_refuses_a_tree_it_does_not_know():
    _, _, _, jq = _trees()
    bad = dict(np_tree(jq), extra={})
    with pytest.raises(ValueError, match="keys"):
        quantized_tree_from_jax(bad)
    bad = np_tree(jq)
    bad["embedding"] = {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}
    with pytest.raises(ValueError, match="expected {q, bias}"):
        quantized_tree_from_jax(bad)


@pytest.mark.parametrize("bridged", [True, False])
def test_quantized_ar_apply_matches_jax(bridged):
    """With the JAX int8 tree bridged, and with the port's own quantisation
    of the bridged float weights."""
    _, _, pm, jq = _trees()
    rng = np.random.default_rng(32)
    src = rng.standard_normal((3, 6, L)).astype(np.float32)
    tgt = rng.standard_normal((3, 5, L)).astype(np.float32)
    want = JQ.quantized_ar_apply(jq, jnp.asarray(src), jnp.asarray(tgt),
                                 tgt_mask=jcausal_mask(5), num_heads=4)
    qp = (quantized_tree_from_jax(np_tree(jq)) if bridged
          else Q.quantize_frame_transformer(pm))
    got = Q.quantized_ar_apply(qp, t(src), t(tgt), tgt_mask=causal_mask(5),
                               num_heads=4)
    assert got.dtype == torch.float32 and got.shape == (3, 5, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_quantized_forward_is_close_to_the_float_forward():
    """The int8 forward tracks the f32 model it was quantised from (the JAX
    package's own check: relative error of a few percent)."""
    _, _, pm, _ = _trees()
    x = t(np.random.default_rng(33).standard_normal((2, 5, L))
          .astype(np.float32))
    with torch.no_grad():
        ref = pm(x, x, tgt_mask=causal_mask(5))
        got = Q.quantized_ar_apply(Q.quantize_frame_transformer(pm), x, x,
                                   tgt_mask=causal_mask(5), num_heads=4)
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel < 0.1


def test_quantized_ar_apply_refuses_the_reference_batch_pe():
    _, _, pm, _ = _trees()
    x = torch.zeros(1, 2, L)
    with pytest.raises(AssertionError, match="pe_mode='timestep' only"):
        Q.quantized_ar_apply(Q.quantize_frame_transformer(pm), x, x,
                             num_heads=4, pe_mode="reference_batch")
