"""Port of ops/groupnorm on the CPU: the plain version against the JAX Pallas
kernel (interpret mode, as tests/test_groupnorm.py runs it) and the JAX
reference, on the same numpy inputs (NCHW here, the NHWC transpose there; and
one NHWC array with no transposition, seen by torch as a channels-last
tensor); ``route`` (which body a tensor's strides select); the CPU dispatch;
and every GroupNorm of the port's VAE and UNet going through the dispatcher
on a channels-last tensor, so that on a GPU no norm escapes the kernel's NHWC
body. The CUDA kernels' own tests are in test_torch_kernels.py.

Tolerance. f32: the same two-pass statistics summed in other orders, rtol
1e-5 / atol 2e-5 (the +100 offset case stays inside it; a one-pass
E[x^2] - mean^2 variance does not, which the test checks). bf16: both sides
compute in f32 from the same bf16 inputs and round once, so they differ by
at most one bf16 ulp where f32 noise meets a rounding boundary (rtol 2^-7);
against the JAX reference computed in f32, by the final rounding alone
(rtol 2^-8).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from sd_video_gen_tpu.ops import groupnorm as jgn
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.unet import (Transformer2D,
                                                UNet2DCondition, UNetConfig)
from sd_video_gen_tpu_torch.models.vae import (AttnBlock, AutoencoderKL,
                                               VAEConfig)
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops import groupnorm as pgn
from torch_port_common import TINY_UNET, TINY_VAE, t

F32_TOL = dict(rtol=1e-5, atol=2e-5)


def _inputs(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + offset).astype(np.float32)
    C = shape[1]
    w = (1.0 + 0.5 * rng.standard_normal(C)).astype(np.float32)
    b = (0.5 * rng.standard_normal(C)).astype(np.float32)
    return x, w, b


def _to_dtype(a, dtype):
    """numpy f32 -> torch tensor of ``dtype`` and its exact f32 value."""
    x = t(a).to(dtype)
    return x, x.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups,offset", [((2, 64, 8, 8), 32, 0.0),
                                                 ((1, 12, 5, 7), 3, 0.0),
                                                 ((2, 64, 8, 8), 32, 100.0)])
def test_reference_matches_jax_kernel_and_reference(shape, groups, offset,
                                                    silu, eps, dtype):
    x, w, b = _inputs(shape, seed=sum(shape) + groups, offset=offset)
    (xt, xv), (wt, wv), (bt, bv) = (_to_dtype(a, dtype) for a in (x, w, b))
    got = pgn.groupnorm_silu_reference(xt, wt, bt, groups, eps, silu)
    assert got.dtype == dtype and got.shape == xt.shape
    got = got.float().permute(0, 2, 3, 1).numpy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xn = np.ascontiguousarray(xv.transpose(0, 2, 3, 1))
    kern = jgn.groupnorm_silu_pallas(jnp.asarray(xn, jdt), jnp.asarray(wv, jdt),
                                     jnp.asarray(bv, jdt), groups, eps, silu,
                                     interpret=True)
    ref = np.asarray(jgn.groupnorm_silu_reference(
        jnp.asarray(xn), jnp.asarray(wv), jnp.asarray(bv), groups, eps, silu))
    kern = np.asarray(kern.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, kern, **F32_TOL)
        np.testing.assert_allclose(got, ref, **F32_TOL)
    else:
        np.testing.assert_allclose(got, kern, rtol=2 ** -7, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=1e-5)
    if offset and dtype == torch.float32:  # this case fails a one-pass var
        g = xn.reshape(shape[0], -1, groups, shape[1] // groups)
        m = g.mean(axis=(1, 3), keepdims=True, dtype=np.float32)
        var1 = (np.square(g).mean(axis=(1, 3), keepdims=True,
                                  dtype=np.float32) - m * m)
        assert np.abs(var1 - g.var(axis=(1, 3), keepdims=True)).max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("nhwc_shape,groups,offset", [
    ((2, 6, 6, 16), 4, 0.0),      # 4 channels per group
    ((1, 5, 7, 40), 4, 0.0),      # 10 per group: vectors cross group edges
    ((2, 4, 4, 60), 2, 0.0),      # 30 per group
    ((2, 6, 6, 16), 4, 100.0)])   # a mean far from zero
def test_channels_last_reference_matches_jax_on_the_same_nhwc_array(
        nhwc_shape, groups, offset, silu, eps, dtype):
    """One numpy NHWC array, no transposition on either side: JAX takes it as
    it is, torch sees its (0, 3, 1, 2) permutation, which is a channels-last
    (B, C, H, W) tensor over the same memory. The plain version keeps that
    memory format, so its output read back as NHWC compares element for
    element. f32 atol 1e-5 (rtol 1e-5 covers the +100 case's larger values);
    bf16 one ulp (2^-7) against the kernel, the rounding alone (2^-8) against
    the f32 reference."""
    rng = np.random.default_rng(sum(nhwc_shape) + groups)
    a = (rng.standard_normal(nhwc_shape) * 2.0 + offset).astype(np.float32)
    C = nhwc_shape[-1]
    w = (1.0 + 0.5 * rng.standard_normal(C)).astype(np.float32)
    b = (0.5 * rng.standard_normal(C)).astype(np.float32)
    tdt = lambda v: torch.from_numpy(v).to(dtype)
    av, wv, bv = (tdt(v).float().numpy() for v in (a, w, b))  # exact values
    x = tdt(a).permute(0, 3, 1, 2)
    assert pgn.route(x) == "nhwc" and not x.is_contiguous()
    got = pgn.groupnorm_silu_reference(x, tdt(w), tdt(b), groups, eps, silu)
    assert got.dtype == dtype and got.shape == x.shape
    assert got.stride() == x.stride()           # memory format kept
    got = got.permute(0, 2, 3, 1)
    assert got.is_contiguous()                  # NHWC memory, no copy needed
    got = got.float().numpy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kern = jgn.groupnorm_silu_pallas(jnp.asarray(av, jdt), jnp.asarray(wv, jdt),
                                     jnp.asarray(bv, jdt), groups, eps, silu,
                                     interpret=True)
    ref = np.asarray(jgn.groupnorm_silu_reference(
        jnp.asarray(av), jnp.asarray(wv), jnp.asarray(bv), groups, eps, silu))
    kern = np.asarray(kern.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, kern, rtol=2 ** -7, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("case,want", [
    ("channels_last", "nhwc"), ("contiguous", "nchw"),
    ("one_channel", "nhwc"), ("one_pixel", "nhwc"),
    ("sliced_channels", None), ("sliced_width", None), ("transposed", None),
    ("three_dims", None)])
def test_route_picks_the_body_from_the_strides(case, want):
    """Dense channels-last -> the NHWC body, contiguous -> the NCHW body; with
    C = 1 or H = W = 1 both hold, the memory is the same either way and the
    NHWC body takes it; any other strides raise (no silent layout copy)."""
    x = torch.zeros(2, 8, 4, 6)
    x = {"channels_last": x.contiguous(memory_format=torch.channels_last),
         "contiguous": x,
         "one_channel": x[:, :1].contiguous(),
         "one_pixel": torch.zeros(3, 8, 1, 1),
         "sliced_channels": x.contiguous(
             memory_format=torch.channels_last)[:, :4],
         "sliced_width": x[..., :3],
         "transposed": x.transpose(2, 3),
         "three_dims": x[0]}[case]
    if want is None:
        with pytest.raises(ValueError, match="contiguous|\\(B, C, H, W\\)"):
            pgn.route(x)
        if x.dim() == 4:   # the dispatcher refuses it too, on any device
            with pytest.raises(ValueError, match="contiguous"):
                pgn.group_norm(nn.GroupNorm(2, x.shape[1]), x, silu=True)
    else:
        assert pgn.route(x) == want
        if case in ("one_channel", "one_pixel"):
            assert x.is_contiguous() and x.is_contiguous(
                memory_format=torch.channels_last)


def test_cpu_dispatch_takes_plain_path_and_never_launches():
    norm = nn.GroupNorm(4, 8, eps=1e-5)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x = t(_inputs((2, 8, 3, 5), seed=1)[0])
    before = _kernels.LAUNCHES["groupnorm_silu"]
    out = pgn.group_norm(norm, x, silu=True)
    want = pgn.groupnorm_silu_reference(x, norm.weight, norm.bias, 4, 1e-5)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  want.detach().numpy())
    with torch.no_grad():  # the plain version is torch's own GroupNorm
        np.testing.assert_allclose(
            pgn.group_norm(norm, x, silu=False).numpy(), norm(x).numpy(),
            rtol=1e-5, atol=1e-5)
    with _kernels.force_reference():
        pgn.group_norm(norm, x, silu=False)
    pgn.group_norm(norm, x, silu=True, force="reference")
    assert _kernels.LAUNCHES["groupnorm_silu"] == before
    with pytest.raises(ValueError, match="unknown force"):
        pgn.group_norm(norm, x, silu=True, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        pgn.groupnorm_silu(x, norm.weight, norm.bias, 4)
    # the plain version and the dispatcher keep a channels-last input's format
    xcl = x.contiguous(memory_format=torch.channels_last)
    with _kernels.record_calls() as rec:
        out_cl = pgn.group_norm(norm, xcl, silu=True)
        pgn.group_norm(norm, x, silu=True)
    assert out_cl.stride() == xcl.stride() and out.is_contiguous()
    np.testing.assert_array_equal(out_cl.detach().numpy(),
                                  out.detach().numpy())
    assert sorted(sig[5] for _, sig in rec.calls) == ["nchw", "nhwc"]
    with pytest.raises(ValueError, match="no path for device meta"):
        pgn.group_norm(norm.to("meta"), x.to("meta"), silu=True)


def _no_module_forward(self, x):
    raise AssertionError("an nn.GroupNorm ran as a module: the norm escaped "
                         "the group_norm dispatcher")


@pytest.mark.parametrize("part", ["vae_encode", "vae_decode", "unet"])
def test_every_norm_goes_through_the_dispatcher(part, monkeypatch):
    """One forward calls the dispatcher once per GroupNorm module of the part
    it runs, without SiLU exactly once per attention block, and every tensor
    it hands the dispatcher is channels-last (inputs arrive contiguous): no
    pad, upsample, concatenation, broadcast add or 1x1 projection on the way
    falls back to NCHW. The attention blocks' token sequences are views of
    the channels-last tensor both ways (no copy)."""
    monkeypatch.setattr(nn.GroupNorm, "forward", _no_module_forward)
    views = []

    def spy_tokens(module, args, output):
        # Transformer2D / AttnBlock: the block's output must still be
        # channels-last, as its input was
        views.append((args[0].stride(), output.stride(),
                      output.is_contiguous(memory_format=torch.channels_last)))
    rng = np.random.default_rng(3)
    if part == "unet":
        model = build(UNet2DCondition, UNetConfig(**TINY_UNET), "cpu")
        counted, attn_cls = model, Transformer2D
        run = lambda: model(t(rng.standard_normal((2, 4, 8, 8), np.float32)),
                            torch.tensor([981.0, 1.0]),
                            t(rng.standard_normal((2, 3, 16), np.float32)))
    else:
        model = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu")
        attn_cls = AttnBlock
        if part == "vae_encode":
            counted = model.encoder
            run = lambda: model.encode(t(rng.uniform(-1, 1, (2, 3, 16, 16))
                                         .astype(np.float32)))
        else:
            counted = model.decoder
            run = lambda: model.decode(t(rng.standard_normal(
                (2, 4, 8, 8), np.float32)))
    hooks = [m.register_forward_hook(spy_tokens) for m in counted.modules()
             if isinstance(m, attn_cls)]
    with _kernels.record_calls() as rec, torch.no_grad():
        out = run()
    for h in hooks:
        h.remove()
    gn = {sig: n for (name, sig), n in rec.calls.items()
          if name == "groupnorm_silu"}
    assert {sig[5] for sig in gn} == {"nhwc"}
    assert views and all(i == o and cl for i, o, cl in views)
    # channels stay the fastest axis to the output (encode's mean and logvar
    # are the two channel halves of one channels-last tensor: views, not dense)
    for o in (out if isinstance(out, tuple) else (out,)):
        assert o.stride(1) == 1 and o.stride(3) > 1
    if not isinstance(out, tuple):
        assert out.is_contiguous(memory_format=torch.channels_last)
    n_norms = sum(isinstance(m, nn.GroupNorm) for m in counted.modules())
    n_attn = sum(isinstance(m, attn_cls) for m in counted.modules())
    assert n_attn >= 1
    assert sum(gn.values()) == n_norms
    assert sum(n for sig, n in gn.items() if not sig[4]) == n_attn


def test_attention_token_views_share_the_channels_last_memory():
    """(B, C, H, W) channels-last -> (B, HW, C) -> back: both are views."""
    x = torch.randn(2, 8, 3, 5).contiguous(memory_format=torch.channels_last)
    tokens = x.flatten(2).transpose(1, 2)
    assert tokens.is_contiguous() and tokens.data_ptr() == x.data_ptr()
    back = tokens.transpose(1, 2).reshape(2, 8, 3, 5)
    assert back.data_ptr() == x.data_ptr() and back.stride() == x.stride()
    assert torch.equal(back, x)


def test_build_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No device given: CUDA, and an error where there is none. The CPU has
    to be asked for; the caller's random state is left alone; convolution
    weights come out channels-last."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(AutoencoderKL, VAEConfig(**TINY_VAE))
    torch.manual_seed(123)
    want = torch.get_rng_state()
    a = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu", seed=7)
    assert torch.equal(torch.get_rng_state(), want)
    b = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu", seed=7)
    c = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu", seed=8)
    wa, wb, wc = (m.encoder.conv_in.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.device.type == "cpu" and not wa.requires_grad
    for p in a.parameters():
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last)


def test_full_width_norm_and_attention_counts():
    """The per-pass counts chip_smoke.py derives its exact launch counts
    from, at the SD-v1.4 widths (built on the meta device: no weights)."""
    vae = build(AutoencoderKL, VAEConfig(), "meta")
    unet = build(UNet2DCondition, UNetConfig(), "meta")
    count = lambda m, cls: sum(isinstance(x, cls) for x in m.modules())
    assert (count(vae.encoder, nn.GroupNorm), count(vae.decoder, nn.GroupNorm),
            count(unet, nn.GroupNorm)) == (22, 30, 61)
    assert (count(vae.encoder, AttnBlock), count(vae.decoder, AttnBlock),
            count(unet, Transformer2D)) == (1, 1, 16)
