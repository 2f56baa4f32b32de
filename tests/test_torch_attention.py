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
    with _kernels.force_reference():
        patt.attention(q, k, v)
    patt.attention(q, k, v, force="reference")
    assert _kernels.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="unknown force"):
        patt.attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        patt.flash_attention(q, k, v)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    patt.attention(qb, kb, vb)
    assert _kernels.LAUNCHES["flash_attention"] == before
    assert sum(patt.ROUTE_LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype,d,ptrs,want", [
    (torch.bfloat16, 40, (0, 16, 4096), "wgmma"),
    (torch.bfloat16, 512, (1 << 20,) * 3, "wgmma"),
    (torch.bfloat16, 8, (32, 48, 64), "wgmma"),
    (torch.bfloat16, 36, (0, 16, 32), "fma"),
    (torch.bfloat16, 44, (0, 16, 32), "fma"),
    (torch.bfloat16, 40, (2, 16, 32), "fma"),
    (torch.bfloat16, 80, (0, 16, 40), "fma"),
    (torch.float32, 40, (0, 16, 32), "fma"),
    (torch.float32, 512, (0, 16, 32), "fma"),
])
def test_route_picks_the_body_by_dtype_head_dim_and_alignment(dtype, d, ptrs,
                                                              want):
    """bf16 with d % 8 == 0 and 16-byte aligned pointers takes the
    tensor-core body (TMA needs both); any other d, an unaligned pointer or
    f32 takes the FMA body."""
    assert patt.route(dtype, d, ptrs) == want


@pytest.mark.parametrize("batch", [1, 2])
def test_callers_hand_attention_contiguous_tensors(batch, monkeypatch):
    """``attention`` copies nothing and its kernel refuses a non-contiguous
    tensor, so the callers make the copy: the UNet's head split at B = 1 is
    a strided view until its explicit ``contiguous``; the VAE's q, k, v come
    out of their projections contiguous."""
    from sd_video_gen_tpu_torch.models import unet, vae
    seen = []

    def spy(module):
        real = module.attention
        monkeypatch.setattr(module, "attention", lambda q, k, v, **kw: (
            seen.append((q.is_contiguous(), k.is_contiguous(),
                         v.is_contiguous())), real(q, k, v, **kw))[1])

    spy(unet)
    spy(vae)
    x = torch.randn(batch, 16, 32)
    unet.CrossAttention(32, heads=4)(x)       # spatial self-attention
    unet.CrossAttention(32, heads=4, context_dim=16)(
        x, torch.randn(batch, 5, 16))         # cross-attention
    block = vae.AttnBlock(
        vae.VAEConfig(block_out_channels=(32,), norm_num_groups=8), 32)
    block(torch.randn(batch, 32, 4, 4).contiguous(
        memory_format=torch.channels_last))
    assert seen == [(True, True, True)] * 3
