"""Port of ops/attention on the CPU: the plain version against the JAX flash
kernel (Pallas interpret mode, several key blocks folded) and the JAX einsum
oracle; the CPU dispatch. The CUDA kernel's own tests are in
test_torch_kernels.py.

Tolerance: f32, two summation orders of the same formula -> rtol 1e-5 /
atol 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.ops import attention as jatt
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops import attention as patt
from torch_port_common import t


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,block", [((4, 64, 40), 16),
                                         ((2, 32, 80), 8),
                                         ((1, 64, 160), 32)])
def test_reference_matches_jax_flash_interpret(shape, block):
    q, k, v = _qkv(shape)
    scale = shape[-1] ** -0.5
    want = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                scale, block_q=block, block_k=block,
                                interpret=True)
    got = patt.reference_attention(t(q), t(k), t(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_reference_matches_jax_reference_and_default_scale():
    q, k, v = _qkv((3, 24, 16), seed=1)
    want = jatt.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    got = patt.reference_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_takes_plain_path_and_never_launches():
    before = _kernels.LAUNCHES["flash_attention"]
    q, k, v = (t(a) for a in _qkv((2, 16, 8), seed=2))
    out = patt.attention(q, k, v, scale=0.3)
    np.testing.assert_array_equal(
        out.numpy(), patt.reference_attention(q, k, v, 0.3).numpy())
    with patt.force_reference():
        patt.attention(q, k, v)
    patt.attention(q, k, v, force="reference")
    assert _kernels.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="unknown force"):
        patt.attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        patt.flash_attention(q, k, v)
