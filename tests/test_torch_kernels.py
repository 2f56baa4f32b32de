"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU: a CUDA
kernel has no CPU mode. This file imports torch only, so it also runs where
JAX is not installed (the repository's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerance: the kernel against the plain version computed in f32 from the same
inputs (TF32 off). Flash attention, f32: the three-TF32-product body atol
3e-5 (3x its worst reading on the card; dropping any one of its cross terms
leaves 4.6e-5 or more, and one TF32 product 1.2e-4 or more:
test_torch_attention.py), the FMA body's order over up to 4096 keys atol
1e-4; bf16 atol 2e-2, p is rounded to bf16 before p.v and the output to
bf16, as in the TPU kernel. Every flash case checks which body
(``attention.route``) it took. GroupNorm+SiLU, |out - ref| <= rtol |ref| +
atol: f32 (1e-5, 1e-5), the same two-pass statistics summed in another
order; bf16 (2^-8, 1e-5), the one final rounding (half an ulp) plus that f32
noise. Both GroupNorm bodies are held to it: a contiguous tensor takes the
NCHW body, a channels-last one the NHWC body (``groupnorm.route``), in its
cluster mode (one read, one launch) or its streaming mode (two of each).
Adam's one-pass update (``train/optim.multi_tensor_adam``): bit-equal to its
plain version, the foreach passes, in every dtype pair the trainer and the
optax test use, eagerly and in a CUDA graph's replay.
"""

import contextlib

import pytest
import torch
from torch import nn

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops import attention as patt
from sd_video_gen_tpu_torch.ops import groupnorm as pgn
from sd_video_gen_tpu_torch.train import optim

GN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -8, 1e-5)}
TF32X3_ATOL = 3e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, TF32X3_ATOL),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(8, 4096, 40), (8, 1024, 80),
                                   (8, 256, 160), (8, 64, 160),
                                   (1, 4096, 512), (5, 64, 512),
                                   (3, 77, 40), (2, 100, 72), (1, 33, 512),
                                   (2, 1, 8), (64, 4096, 40), (64, 1024, 80),
                                   (8, 4096, 512), (40, 64, 512),
                                   (3, 65, 160), (2, 130, 40), (2, 65, 512),
                                   (2, 130, 256), (2, 65, 128), (2, 64, 64),
                                   (1, 36, 36),
                                   (16, 4096, 40), (16, 1024, 80),
                                   (16, 256, 160), (16, 64, 160),
                                   (64, 64, 40), (64, 16, 80), (64, 4, 160),
                                   (64, 1, 160), (160, 64, 512),
                                   (640, 64, 512)])
def test_flash_attention_matches_plain(cuda, shape, dtype, atol):
    """Path shapes (the classifier-free-guidance pair doubles BH to 16; the
    native 64px refiner takes the UNet to T = 64, 16, 4 and 1, shorter than
    a key tile; the VAE codec at 160 and 640 frames), plus ragged T (T = 65
    and 130: one or two keys past a tile on the two-stage ring), head dims between the kernel's buckets (run
    in the next bucket up) and d = 36 (not a multiple of 8: the FMA body in
    bf16; f32 takes its tensor-core body wherever d % 4 == 0)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    _check_flash(q, k, v, dtype, atol)


def _check_flash(q, k, v, dtype, atol, want_route=None):
    scale = q.shape[-1] ** -0.5
    body = patt.route(dtype, q.shape[-1],
                      (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    if want_route is not None:
        assert body == want_route
    before = _kernels.LAUNCHES["flash_attention"]
    before_body = patt.ROUTE_LAUNCHES[body]
    out = patt.attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_attention"] == before + 1
    assert patt.ROUTE_LAUNCHES[body] == before_body + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = patt.reference_attention(q.float(), k.float(), v.float(), scale)
    assert (out.float() - ref).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", [((2, 64, 40), "wgmma"),
                                        ((2, 64, 36), "fma"),
                                        ((2, 130, 512), "wgmma")])
def test_flash_attention_bf16_routes(cuda, shape, want):
    """bf16: aligned with d % 8 == 0 takes the tensor-core body, d = 36 the
    FMA body; an offset view whose data pointer is not 16-byte aligned
    (contiguous, as the caller made it) takes the FMA body, as ``route``
    says, and still matches."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    _check_flash(q, k, v, torch.bfloat16, 2e-2, want)
    n = q.numel()
    flat = torch.randn(n + 1, generator=g, device=cuda).bfloat16()
    q_off = flat[1:].view(shape)          # 2 bytes past an aligned start
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 == 2
    _check_flash(q_off, k, v, torch.bfloat16, 2e-2, "fma")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 40), (4, 256, 80), (4, 256, 160),
                                   (2, 256, 512), (3, 130, 40), (3, 130, 160),
                                   (2, 130, 512), (4, 200, 64), (2, 97, 200),
                                   (2, 64, 300)])
def test_flash_attention_f32_takes_the_tf32x3_body(cuda, shape):
    """f32 with d % 4 == 0 and aligned pointers: the three-product body in
    each head-dim bucket (40, 80, 160, 512), at a ragged T (130, 97: keys
    past the last 64-key tile) and at head dims between the buckets (64,
    200, 300: the next bucket up, TMA filling the columns past d)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=cuda)
               for _ in range(3))
    _check_flash(q, k, v, torch.float32, TF32X3_ATOL, "tf32x3")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 130, 38), (2, 64, 510)])
def test_flash_attention_f32_fma_body_where_tma_cannot_serve(cuda, shape):
    """f32 with d % 4 != 0 takes the FMA body; so does an aligned-d tensor
    whose data pointer is 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=g, device=cuda)
               for _ in range(3))
    _check_flash(q, k, v, torch.float32, 1e-4, "fma")
    shape = (2, 130, 40)
    flat = torch.randn(2 * 130 * 40 + 1, generator=g, device=cuda)
    q_off = flat[1:].view(shape)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 == 4
    k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    _check_flash(q_off, k, v, torch.float32, 1e-4, "fma")


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        patt.flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        patt.flash_attention(x, x, x)
    x = torch.zeros(1, 4, 520, device=cuda)
    with pytest.raises(ValueError, match="d <= 512"):
        patt.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="equal"):
        patt.flash_attention(q, q[:, :4], q[:, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [
    ((1, 256, 512, 512), 32), ((8, 128, 256, 256), 32),
    ((8, 320, 64, 64), 32), ((8, 2560, 8, 8), 32), ((1, 1280, 8, 8), 32),
    ((40, 512, 8, 8), 32),
    ((1, 12, 5, 7), 3), ((2, 6, 3, 3), 2), ((3, 64, 1, 1), 32),
    ((1, 8, 1, 4099), 1),
    ((2, 320, 64, 64), 32), ((8, 1280, 1, 1), 32), ((32, 128, 64, 64), 32)])
def test_groupnorm_silu_matches_plain(cuda, shape, groups, silu, eps, dtype):
    """Path shapes (the largest slab, VAE and UNet levels at B=1 and 8), plus
    rows that are not a whole number of 16-byte vectors (scalar variant),
    ragged chunks, 1x1 maps and a group larger than one chunk at HW odd."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    C = shape[1]
    w = (1 + 0.5 * torch.randn(C, generator=g, device=cuda)).to(dtype)
    b = (0.5 * torch.randn(C, generator=g, device=cuda)).to(dtype)
    norm = nn.GroupNorm(groups, C, eps=eps).to(cuda, dtype)
    norm.requires_grad_(False)         # frozen, as ``models.build`` makes it
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    before = _kernels.LAUNCHES["groupnorm_silu"]
    out = pgn.group_norm(norm, x, silu)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["groupnorm_silu"] == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = pgn.groupnorm_silu_reference(x.float(), w.float(), b.float(),
                                       groups, eps, silu)
    rtol, atol = GN_TOL[dtype]
    assert ((out.float() - ref).abs() <= rtol * ref.abs() + atol).all()
    with _kernels.force_reference():
        pgn.group_norm(norm, x, silu)
    assert _kernels.LAUNCHES["groupnorm_silu"] == before + 1


def _gn_inputs(shape, dtype, device):
    """x (contiguous), weight, bias from a seed: a mean away from zero."""
    g = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    C = shape[1]
    w = (1 + 0.5 * torch.randn(C, generator=g, device=device)).to(dtype)
    b = (0.5 * torch.randn(C, generator=g, device=device)).to(dtype)
    return x, w, b


def _check_nhwc(x, w, b, groups, eps, silu, mode=None):
    """The NHWC body on channels-last ``x`` against the plain version in f32;
    one count per call, on the ``nhwc`` body; the memory format is kept."""
    assert pgn.route(x) == "nhwc"
    before = _kernels.LAUNCHES["groupnorm_silu"]
    nhwc_before = pgn.ROUTE_LAUNCHES["nhwc"]
    out = (pgn.groupnorm_silu(x, w, b, groups, eps, silu) if mode is None
           else pgn._launch(x, w, b, groups, eps, silu, mode))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["groupnorm_silu"] == before + 1
    assert pgn.ROUTE_LAUNCHES["nhwc"] == nhwc_before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    assert out.stride() == x.stride()
    ref = pgn.groupnorm_silu_reference(x.float(), w.float(), b.float(),
                                       groups, eps, silu)
    rtol, atol = GN_TOL[x.dtype]
    assert ((out.float() - ref).abs() <= rtol * ref.abs() + atol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
@pytest.mark.parametrize("shape,groups,mode", [
    # the path's hot shapes; 32 groups of 4, 8, 16, 10, 20, 30, 40, 60, 80
    ((1, 128, 512, 512), 32, "streaming"),     # cpg 4, too large to hold
    ((2, 256, 256, 256), 32, None),            # cpg 8
    ((8, 512, 128, 128), 32, "streaming"),     # cpg 16; fits a cluster of 8
    ((8, 512, 64, 64), 32, "cluster"),          # two waves of clusters of 2
    ((8, 1280, 32, 32), 32, "cluster"),        # tiles of 160 KB
    ((8, 320, 64, 64), 32, "cluster"),         # cpg 10: vectors cross groups
    ((1, 320, 64, 64), 32, "cluster"),         # B = 1: clusters grown
    ((8, 640, 32, 32), 32, "cluster"),         # cpg 20
    ((8, 960, 64, 64), 32, "streaming"),       # cpg 30; fits a cluster of 8
    ((8, 1280, 16, 16), 32, "cluster"),        # cpg 40
    ((8, 1920, 32, 32), 32, "cluster"),        # cpg 60
    ((8, 2560, 8, 8), 32, "cluster"),          # cpg 80
    ((40, 512, 8, 8), 32, "cluster"),
    # ragged H * W, rows that are no whole number of 16-byte vectors (the
    # one-element variant), one pixel, one long row, a single group
    ((2, 64, 3, 5), 32, None), ((2, 64, 65, 33), 32, "cluster"),
    ((1, 12, 5, 7), 3, None), ((2, 6, 3, 3), 2, None),
    ((3, 64, 1, 1), 32, None), ((1, 8, 1, 4099), 1, None),
    ((2, 36, 9, 7), 6, None),
    # the classifier-free-guidance pair (N = 2), the native 64px refiner
    # (8x8 down to 1x1 at B = 8, where channels-last and contiguous strides
    # coincide) and the VAE codec at 32 to 640 frames
    ((2, 320, 64, 64), 32, None), ((2, 640, 32, 32), 32, None),
    ((2, 1280, 16, 16), 32, None), ((2, 2560, 8, 8), 32, None),
    ((8, 320, 8, 8), 32, None), ((8, 640, 4, 4), 32, None),
    ((8, 1280, 2, 2), 32, None), ((8, 1280, 1, 1), 32, None),
    ((8, 2560, 1, 1), 32, None), ((32, 128, 64, 64), 32, None),
    ((160, 128, 64, 64), 32, None), ((640, 512, 8, 8), 32, None),
    ((640, 256, 32, 32), 32, None)])
def test_groupnorm_silu_nhwc_matches_plain(cuda, shape, groups, mode, silu,
                                           eps, dtype):
    x, w, b = _gn_inputs(shape, dtype, cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    plan = pgn.nhwc_plan(shape[0], shape[1], shape[2] * shape[3], groups,
                         dtype)
    if mode is not None and dtype == torch.bfloat16:
        assert plan["mode"] == mode
    assert (plan["workspace"] == 0) == (plan["mode"] == "cluster")
    _check_nhwc(x, w, b, groups, eps, silu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["cluster", "streaming"])
@pytest.mark.parametrize("shape,groups", [
    ((8, 320, 64, 64), 32), ((2, 512, 32, 32), 32), ((2, 64, 65, 33), 32),
    ((1, 12, 5, 7), 3), ((3, 64, 1, 1), 32), ((2, 1280, 8, 8), 32),
    ((8, 960, 64, 64), 32), ((3, 256, 128, 128), 32)])
def test_groupnorm_silu_nhwc_every_mode_gives_the_same_answer(cuda, shape,
                                                               groups, mode,
                                                               dtype):
    """Each mode pinned at shapes where the plan might take another: the
    cluster mode (one launch, partials through distributed shared memory)
    and the streaming mode (two launches, partials through a workspace)."""
    x, w, b = _gn_inputs(shape, dtype, cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    plan = pgn.nhwc_plan(shape[0], shape[1], shape[2] * shape[3], groups,
                         dtype, mode=mode)
    assert plan["mode"] == mode
    assert (plan["workspace"] == 0) == (mode == "cluster")
    _check_nhwc(x, w, b, groups, 1e-6, True, mode=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_nhwc_cluster_mode_takes_several_waves(cuda, dtype):
    """More clusters than the card holds at once, each of several blocks
    whose pixel ranges do not divide H * W evenly: a unit that the plan
    would stream, held in clusters when asked to."""
    shape = (5, 256, 250, 130)
    x, w, b = _gn_inputs(shape, dtype, cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    assert pgn.nhwc_plan(5, 256, 250 * 130, 32, dtype)["mode"] == "streaming"
    plan = pgn.nhwc_plan(5, 256, 250 * 130, 32, dtype, mode="cluster")
    assert plan["mode"] == "cluster" and plan["cluster"] > 1
    assert plan["blocks"] * plan["cluster"] > 132
    _check_nhwc(x, w, b, 32, 1e-5, True, mode="cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc-cluster", "nhwc-streaming", "nchw"])
def test_groupnorm_silu_f32_holds_at_large_activations(cuda, layout):
    """SiLU far from zero in f32 (normalised values scaled by ~20 and shifted
    by up to +-30, so |y| reaches ~100): exp and the division are exact
    enough for the f32 tolerance on every body."""
    shape, dtype = (2, 64, 24, 24), torch.float32
    x, w, b = _gn_inputs(shape, dtype, cuda)
    w, b = w * 20.0, b * 60.0
    if layout == "nchw":
        out = pgn.groupnorm_silu(x, w, b, 32, 1e-5, True)
    else:
        x = x.contiguous(memory_format=torch.channels_last)
        out = pgn._launch(x, w, b, 32, 1e-5, True, layout.split("-")[1])
    ref = pgn.groupnorm_silu_reference(x, w, b, 32, 1e-5, True)
    assert ref.abs().max() > 50
    rtol, atol = GN_TOL[dtype]
    assert ((out - ref).abs() <= rtol * ref.abs() + atol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_nhwc_unaligned_pointer_takes_scalar_loads(cuda,
                                                                  dtype):
    """A channels-last view that starts one element into its storage is not
    16-byte aligned: the plan drops to one element per load."""
    flat = torch.randn(2 * 64 * 9 * 9 + 1, device=cuda).to(dtype)
    x = flat[1:].view(2, 9, 9, 64).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16 != 0
    _, w, b = _gn_inputs((2, 64, 9, 9), dtype, cuda)
    assert pgn.nhwc_plan(2, 64, 81, 32, dtype, aligned=False)["vector"] == 1
    assert pgn.nhwc_plan(2, 64, 81, 32, dtype)["vector"] > 1
    _check_nhwc(x, w, b, 32, 1e-5, True)


@pytest.mark.cuda
def test_group_norm_dispatch_follows_the_memory_format(cuda):
    """The dispatcher launches the body ``route`` names, keeps the format,
    makes no copy of a tensor neither body takes (it raises), and both
    bodies agree to the bf16 rounding on the same values."""
    x, w, b = _gn_inputs((2, 64, 16, 16), torch.bfloat16, cuda)
    norm = nn.GroupNorm(32, 64, eps=1e-6).to(cuda, torch.bfloat16)
    norm.requires_grad_(False)         # frozen, as ``models.build`` makes it
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    xcl = x.contiguous(memory_format=torch.channels_last)
    counts = dict(pgn.ROUTE_LAUNCHES)
    a = pgn.group_norm(norm, x, True)
    c = pgn.group_norm(norm, xcl, True)
    torch.cuda.synchronize()
    assert pgn.ROUTE_LAUNCHES["nchw"] == counts.get("nchw", 0) + 1
    assert pgn.ROUTE_LAUNCHES["nhwc"] == counts.get("nhwc", 0) + 1
    assert a.is_contiguous() and c.stride() == xcl.stride()
    assert ((a.float() - c.float()).abs()
            <= 2 ** -7 * a.float().abs() + 1e-5).all()
    with pytest.raises(ValueError, match="contiguous"):
        pgn.group_norm(norm, xcl[:, :, :, :8], True)
    with _kernels.force_reference():
        r = pgn.group_norm(norm, xcl, True)
    assert r.stride() == xcl.stride()


@pytest.mark.cuda
def test_groupnorm_silu_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(2, 8, 4, 4, device=cuda)
    w = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        pgn.groupnorm_silu(x.half(), w.half(), w.half(), 4)
    with pytest.raises(ValueError, match="dtypes"):
        pgn.groupnorm_silu(x, w.bfloat16(), w.bfloat16(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        pgn.groupnorm_silu(x.transpose(2, 3), w, w, 4)
    with pytest.raises(ValueError, match="do not split"):
        pgn.groupnorm_silu(x, w, w, 3)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        pgn.groupnorm_silu(x[0], w, w, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pgn.groupnorm_silu(x.cpu(), w.cpu(), w.cpu(), 4)


# -- the training path: a frozen f32 VAE encode of 128px frames inside the
# step, and the launchers' refusal to sit inside an autograd graph ----------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 512), (3, 256, 512)])
def test_flash_attention_f32_training_shape_takes_the_tf32x3_body(cuda,
                                                                 shape):
    """The VAE mid-block attention of a 128px encode (T = 16 x 16, d = 512)
    in f32, at a reduced batch (the step's is 320): the three-product
    tensor-core body."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda)
               for _ in range(3))
    _check_flash(q, k, v, torch.float32, TF32X3_ATOL, "tf32x3")


@pytest.mark.cuda
@pytest.mark.parametrize("silu,eps", [(True, 1e-6), (False, 1e-6)])
@pytest.mark.parametrize("shape", [
    (16, 128, 128, 128), (16, 128, 64, 64), (16, 256, 64, 64),
    (16, 256, 32, 32), (16, 512, 32, 32), (16, 512, 16, 16),
    (320, 512, 16, 16)])
def test_groupnorm_silu_nhwc_f32_training_shapes(cuda, shape, silu, eps):
    """Every GroupNorm shape of the VAE encoder at 128px, f32,
    channels-last, at a reduced batch (the step's is 320; the smallest
    shape also at 320)."""
    x, w, b = _gn_inputs(shape, torch.float32, cuda)
    _check_nhwc(x.contiguous(memory_format=torch.channels_last), w, b, 32,
                eps, silu)


@pytest.mark.cuda
def test_launchers_refuse_to_sit_inside_an_autograd_graph(cuda):
    """With grad mode on and an input that requires grad, both launchers and
    both dispatchers raise instead of returning a result without a
    ``grad_fn``; under ``no_grad`` they launch and count as ever."""
    q = torch.randn(2, 64, 40, device=cuda, requires_grad=True)
    k = torch.randn(2, 64, 40, device=cuda)
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
            patt.flash_attention(*args)
        with pytest.raises(RuntimeError, match="flash_attention"):
            patt.attention(*args)
    before = _kernels.LAUNCHES["flash_attention"]
    with torch.no_grad():
        out = patt.attention(q, k, k)
    assert not out.requires_grad
    assert _kernels.LAUNCHES["flash_attention"] == before + 1

    x, w, b = _gn_inputs((2, 64, 8, 8), torch.float32, cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    for i in range(3):
        args = [x, w, b]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="groupnorm_silu.*no backward"):
            pgn.groupnorm_silu(*args, 32)
    norm = nn.GroupNorm(32, 64, device=cuda)           # trainable by default
    with pytest.raises(RuntimeError, match="groupnorm_silu"):
        pgn.group_norm(norm, x, True)
    before = _kernels.LAUNCHES["groupnorm_silu"]
    with torch.no_grad():
        pgn.group_norm(norm, x, True)
    pgn.group_norm(norm.requires_grad_(False), x, True)
    assert _kernels.LAUNCHES["groupnorm_silu"] == before + 2


@pytest.mark.cuda
def test_attention_dispatch_copies_nothing(cuda):
    """A non-contiguous input is refused by the launcher, not copied."""
    x = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        patt.attention(x, x, x)


# Adam's table: ragged tails (numel % 8 != 0), one element, one of the
# transformer's 12.6M fused projections, and a parameter without gradient
ADAM_SHAPES = {"one": (1,), "tail": (13,), "qkv": (6144, 2048),
               "ragged": (1000003,), "small": (33, 7), "bias": (2048,),
               "unused": (5, 3)}
ADAM_PAIRS = [(torch.float32, None), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16)]


def _adam_case(dtype, device, updates=3):
    gen = torch.Generator().manual_seed(21)
    params = {k: (torch.randn(s, generator=gen) * 0.02).to(dtype).to(device)
              for k, s in ADAM_SHAPES.items()}
    grads = [{k: None if k == "unused" else
              (torch.randn(s, generator=gen) * scale).to(dtype).to(device)
              for k, s in ADAM_SHAPES.items()}
             for scale in (1.0, 1e-3, 10.0)[:updates]]
    return params, grads


def _adam_run(params, grads, mu_dtype, plain: bool):
    opt = optim.Adam(1e-3, mu_dtype=mu_dtype)
    p = {k: v.clone() for k, v in params.items()}
    state = opt.init(p)
    before = _kernels.LAUNCHES[optim.KERNEL]
    with _kernels.force_reference() if plain else contextlib.nullcontext():
        for count, g in enumerate(grads, start=1):
            opt.update(p, g, state, count)
    torch.cuda.synchronize()
    return p, state, _kernels.LAUNCHES[optim.KERNEL] - before


def _assert_same_adam(got, want, params):
    for tree, a, b in (("p", got[0], want[0]), ("mu", got[1]["mu"],
                                                 want[1]["mu"]),
                       ("nu", got[1]["nu"], want[1]["nu"])):
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert torch.equal(a[k], b[k]), (tree, k, float(
                (a[k].float() - b[k].float()).abs().max()))
    assert torch.equal(got[0]["unused"], params["unused"])
    assert not got[1]["mu"]["unused"].any()
    assert not got[1]["nu"]["unused"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mu_dtype", ADAM_PAIRS)
def test_adam_kernel_is_bit_equal_to_its_plain_version(cuda, dtype, mu_dtype):
    """Three updates of the table, one launch each (one group), against the
    foreach passes under ``force_reference`` (no launch): p, mu and nu bit
    for bit; the parameter without gradient and its moments untouched."""
    params, grads = _adam_case(dtype, cuda)
    got = _adam_run(params, grads, mu_dtype, plain=False)
    want = _adam_run(params, grads, mu_dtype, plain=True)
    assert (got[2], want[2]) == (3, 0)
    assert got[1]["mu"]["qkv"].dtype == (mu_dtype or dtype)
    _assert_same_adam(got, want, params)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mu_dtype", ADAM_PAIRS)
def test_adam_kernel_in_a_graph_replay(cuda, dtype, mu_dtype):
    """The update captured once into a CUDA graph (one launch counted at the
    capture) and replayed three times, the host filling each step's bias
    corrections and gradients between replays, as the compiled train step
    does: bit-equal to three eager updates of the plain version."""
    params, grads = _adam_case(dtype, cuda)
    want = _adam_run(params, grads, mu_dtype, plain=True)
    opt = optim.Adam(1e-3, mu_dtype=mu_dtype)
    p = {k: v.clone() for k, v in params.items()}
    state = opt.init(p)
    static = {k: None if g is None else torch.zeros_like(g)
              for k, g in grads[0].items()}
    # warm-up on copies: builds the library, sizes the grid
    scratch = {k: v.clone() for k, v in p.items()}
    opt.update(scratch, grads[0], opt.init(scratch), 1)
    torch.cuda.synchronize()
    before = _kernels.LAUNCHES[optim.KERNEL]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.update(p, static, state)
    assert _kernels.LAUNCHES[optim.KERNEL] == before + 1
    for count, g in enumerate(grads, start=1):
        for k, t in static.items():
            if t is not None:
                t.copy_(g[k])
        opt.set_count(p, state, count)
        graph.replay()
    torch.cuda.synchronize()
    _assert_same_adam((p, state), want, params)


@pytest.mark.cuda
def test_adam_kernel_rejects_what_it_cannot_take(cuda):
    p = torch.zeros(64, device=cuda)
    bc = torch.ones((), device=cuda)
    scalars = optim.Adam(1e-3).scalars(torch.float32, torch.float32)

    def launch(q=p, g=p, m=p, n=p, b=bc):
        optim.multi_tensor_adam([q], [g], [m], [n], b, bc, scalars)
    with pytest.raises(ValueError, match="contiguous"):
        launch(g=torch.zeros(8, 16, device=cuda).t().reshape(8, 16).t())
    with pytest.raises(ValueError, match="aligned"):
        launch(q=torch.zeros(65, device=cuda)[1:])
    with pytest.raises(ValueError, match="group of"):
        launch(n=p.bfloat16())
    with pytest.raises(ValueError, match="kernel takes"):
        launch(q=p.half(), g=p.half(), m=p.half(), n=p.half())
    with pytest.raises(ValueError, match="bias correction"):
        launch(b=torch.ones(1, device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        launch(g=torch.zeros(8, 8, device=cuda))
