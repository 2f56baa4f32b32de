"""Port of ops/attention on the CPU: the plain version against the JAX flash
kernel (Pallas interpret mode, several key blocks folded) and the JAX einsum
oracle; the CPU dispatch; the routing of the CUDA kernel's bodies and, in
numpy, the arithmetic of its f32 tensor-core body (three TF32 products).
The CUDA kernel's own tests are in test_torch_kernels.py.

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
    (torch.float32, 40, (0, 16, 32), "tf32x3"),
    (torch.float32, 512, (0, 16, 32), "tf32x3"),
    (torch.float32, 36, (0, 16, 4096), "tf32x3"),
    (torch.float32, 4, (1 << 20,) * 3, "tf32x3"),
    (torch.float32, 38, (0, 16, 32), "fma"),
    (torch.float32, 42, (0, 16, 32), "fma"),
    (torch.float32, 40, (4, 16, 32), "fma"),
    (torch.float32, 512, (0, 8, 32), "fma"),
])
def test_route_picks_the_body_by_dtype_head_dim_and_alignment(dtype, d, ptrs,
                                                              want):
    """With 16-byte aligned pointers (TMA needs them, and a row stride that
    is a multiple of 16 bytes): bf16 with d % 8 == 0 takes the bf16
    tensor-core body, f32 with d % 4 == 0 the f32 one (three TF32
    products); any other d or an unaligned pointer takes the FMA body."""
    assert patt.route(dtype, d, ptrs) == want


def _tf32_rna(x):
    """TF32 of f32 ``x`` rounded to nearest, ties away from zero, as the
    kernel rounds (its ``tf32_rna``, the value of ``cvt.rna.tf32.f32``): add
    half an ulp of TF32 to the bits and clear the 13 low ones."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


THREE = ("bb", "bs", "sb")
# The f32 tensor-core body's limit against the plain version on the card
# (chip_smoke.py, test_torch_kernels.py).
TF32X3_ATOL = 3e-5
TF32_SHAPES = [(2, 256, 512), (2, 256, 40), (1, 1024, 80)]


def _tf32_attention(q, k, v, s_terms=THREE, o_terms=THREE):
    """Attention with S = q k^T and o = p v each summed from the terms
    named: "bb" big * big, "bs" big * small, "sb" small * big, big =
    tf32(x), small = tf32(x - big). All three is what the kernel's f32 body
    makes, "bb" alone one TF32 product. The products are summed in f64, so
    only the operands' rounding is measured; p is rounded to f32 as the
    kernel holds it."""
    def mm(a, b, terms):
        ab, bb = _tf32_rna(a), _tf32_rna(b)
        parts = {"bb": (ab, bb), "bs": (ab, _tf32_rna(b - bb)),
                 "sb": (_tf32_rna(a - ab), bb)}
        return sum(x.astype(np.float64) @ y.astype(np.float64)
                   for x, y in (parts[t] for t in terms))

    s = mm(q, k.transpose(0, 2, 1), s_terms) * q.shape[-1] ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    return mm(p.astype(np.float32), v, o_terms) / p.sum(-1, keepdims=True)


def _f64_attention(q, k, v):
    s = q.astype(np.float64) @ k.astype(np.float64).transpose(0, 2, 1)
    s = s * q.shape[-1] ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p @ v.astype(np.float64)) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_three_tf32_products_hold_the_f32_tolerance_and_one_does_not(shape):
    """Why the f32 body may run on the tensor cores: against f64 attention,
    three TF32 products stay far inside the f32 tolerance of 1e-4 (about
    1e-7 here), while one TF32 product leaves it (1.2e-4 to 3.4e-4 here)."""
    q, k, v = _qkv(shape)
    want = _f64_attention(q, k, v)
    err3 = np.abs(_tf32_attention(q, k, v) - want).max()
    err1 = np.abs(_tf32_attention(q, k, v, ("bb",), ("bb",)) - want).max()
    assert err3 <= 1e-6
    assert err1 > 1e-4


@pytest.mark.parametrize("product", ["s", "o"])
@pytest.mark.parametrize("dropped", ["bs", "sb"])
@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_a_body_missing_a_cross_term_fails_the_tf32x3_limit(shape, dropped,
                                                            product):
    """The f32 body's own limit catches a body that drops either cross term
    of either product: against f64 attention that leaves 4.6e-5 to 2.4e-4
    here, over the 3e-5 limit; four of these twelve cases (4.6e-5 to
    8.8e-5) lie inside the FMA body's 1e-4, which could not tell them."""
    q, k, v = _qkv(shape)
    kept = tuple(t for t in THREE if t != dropped)
    terms = {"s_terms": kept} if product == "s" else {"o_terms": kept}
    err = np.abs(_tf32_attention(q, k, v, **terms) - _f64_attention(q, k, v)
                 ).max()
    assert err > TF32X3_ATOL


def test_tf32_rounding_is_to_nearest_with_ties_away_and_exact_in_parts():
    """The split's rounding: nearest, ties away from zero, 13 low bits
    clear, and big + small carries x to within 2^-22 of its size."""
    ulp = 2.0 ** -10          # TF32's ulp at 1.0
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                  1 + 1.5 * ulp, 3.0], np.float32)
    np.testing.assert_array_equal(
        _tf32_rna(x), np.array([1 + ulp, 1, -(1 + ulp), 1 + 2 * ulp, 3.0],
                               np.float32))
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(10000) * 10.0 ** rng.integers(-3, 4, 10000)
         ).astype(np.float32)
    big = _tf32_rna(x)
    small = _tf32_rna(x - big)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    rel = np.abs(big.astype(np.float64) + small - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22


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
