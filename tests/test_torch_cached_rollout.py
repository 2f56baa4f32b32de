"""The port's KV-cached rollout (``ops/cached_rollout.py``) against the JAX
package on the CPU, and against the port's own full rollout on frame 1.

Tolerance: f32 on both sides, other summation orders: rtol 1e-4 / atol 1e-5
(the bound ``tests/test_cached_rollout.py`` holds the JAX path to). The int8
tree accumulates in int32 on both sides and is held to the same bound given
the same int8 weights.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.ops.cached_rollout import (
    cached_rollout as jcached_rollout,
    quantize_rollout_params as jquantize_rollout_params)
from sd_video_gen_tpu_torch.diffusion.weights import quantized_tree_from_jax
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops.cached_rollout import (cached_rollout,
                                                       quantize_rollout_params)
from sd_video_gen_tpu_torch.ops.quantized import param_tree
from sd_video_gen_tpu_torch.ops.rollout import ar_rollout
from torch_port_common import TINY_FT, np_tree, t, transformer_pair

L, PRED = 16, 4


def _context(seed, batch=2, frames=5):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames + 1, L)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return transformer_pair(L, seed=40)


def test_cached_rollout_matches_jax_with_a_refine_hook(pair):
    jm, params, pm = pair
    ctx = _context(41)
    hook = lambda x, step: x * 0.5 + step       # step index reaches the hook
    want = jax.jit(lambda p, c: jcached_rollout(
        jm.cfg, p, c, PRED, refine_fn=hook))(params, jnp.asarray(ctx))
    steps = []

    def rec(x, step):
        steps.append(step)
        return hook(x, step)
    with torch.no_grad():
        got = cached_rollout(pm.cfg, pm, t(ctx), PRED, refine_fn=rec)
    assert steps == [0, 1, 2, 3]
    assert got.shape == (2, PRED, L) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_first_cached_frame_is_the_full_rollouts(pair):
    """Same src, same tgt, same causal math: frame 1 of both paths agrees;
    later frames differ by construction (frozen memory)."""
    _, _, pm = pair
    ctx = t(_context(42, batch=3))
    with torch.no_grad():
        full = ar_rollout(pm, ctx, PRED, window=5)
        cached = cached_rollout(pm.cfg, param_tree(pm), ctx, PRED)
    torch.testing.assert_close(cached[:, 0], full[:, 0], rtol=1e-4, atol=1e-4)
    assert not torch.allclose(cached[:, 1:], full[:, 1:], atol=1e-3)


def test_a_single_frame_needs_no_decode_step(pair):
    jm, params, pm = pair
    ctx = _context(43, frames=2)
    want = jcached_rollout(jm.cfg, params, jnp.asarray(ctx), 1)
    with torch.no_grad():
        got = cached_rollout(pm.cfg, pm, t(ctx), 1)
    assert got.shape == (2, 1, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_int8_cached_rollout_matches_jax_given_the_same_int8_weights(pair):
    jm, params, pm = pair
    jq = jquantize_rollout_params(params)
    ctx = _context(44)
    want = jax.jit(lambda p, c: jcached_rollout(jm.cfg, p, c, PRED))(
        jq, jnp.asarray(ctx))
    with torch.no_grad():
        bridged = cached_rollout(pm.cfg, quantized_tree_from_jax(np_tree(jq)),
                                 t(ctx), PRED)
        own = cached_rollout(pm.cfg, quantize_rollout_params(pm), t(ctx),
                             PRED)
    np.testing.assert_allclose(bridged.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(own, bridged, rtol=0, atol=0)


def test_bf16_tree_computes_in_bf16_and_returns_f32(pair):
    _, _, pm = pair
    import copy
    half = copy.deepcopy(pm).to(torch.bfloat16)
    ctx = t(_context(45))
    with torch.no_grad():
        got = cached_rollout(half.cfg, half, ctx, 3)
        ref = cached_rollout(pm.cfg, pm, ctx, 3)
    assert param_tree(half)["dtype"] == torch.bfloat16
    assert got.dtype == torch.float32
    assert ((got - ref).norm() / ref.norm()).item() < 0.05


@pytest.mark.parametrize("kw,pred,match", [
    (dict(mode="future"), 2, "supports mode='ar'"),
    (dict(pe_mode="reference_batch"), 2, "reference_batch"),
    (dict(max_len=8), 4, "exceeds positional table max_len=8")])
def test_guards_raise_as_the_jax_package_does(kw, pred, match):
    cfg = FrameTransformerConfig(latent_dim=L, **{**TINY_FT, **kw})
    pm = build(FrameTransformer, cfg, "cpu")
    with pytest.raises(AssertionError, match=match):
        cached_rollout(cfg, pm, t(_context(46)), pred)
