"""GroupNorm (+ optional SiLU): the hand-written CUDA kernel and its plain version.

Counterpart of ``sd_video_gen_tpu/ops/groupnorm.py``. Every GroupNorm of the
port's VAE and UNet goes through ``group_norm``: the resnet preambles (GN ->
SiLU) and ``conv_norm_out`` with SiLU, the VAE attention block's norm and the
UNet ``Transformer2D`` input norm without. The JAX models use flax
``GroupNorm`` + ``silu`` there; the arithmetic is the same.

``groupnorm_silu`` launches ``csrc/groupnorm_silu.cu`` (a split reduction over
each (batch, group): per-chunk mean and M2, merged per group, then one
normalise + affine + SiLU pass); ``groupnorm_silu_reference`` is the plain
version it is held against. Both take NCHW, the models' layout.

Dispatch (``group_norm``): CPU tensors take the plain version, CUDA tensors
always take the kernel, and ``force='reference'`` or
``_kernels.force_reference`` send a call to the plain version. Any other
device raises.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_video_gen_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def groupnorm_silu_reference(x, weight, bias, num_groups: int,
                             eps: float = 1e-6, silu: bool = True):
    """(B, C, H, W) GroupNorm in f32 (two-pass variance), the per-channel
    affine, optional SiLU, output in x's dtype: the CPU path and the
    kernel's oracle."""
    B, C = x.shape[:2]
    g = x.float().reshape(B, num_groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = (g - mean).square().mean(dim=2, keepdim=True)
    n = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    out = n * weight.float().reshape(shape) + bias.float().reshape(shape)
    return (out * torch.sigmoid(out) if silu else out).to(x.dtype)


def groupnorm_silu(x, weight, bias, num_groups: int, eps: float = 1e-6,
                   silu: bool = True):
    """Launch the CUDA kernel on a contiguous (B, C, H, W) f32/bf16 CUDA
    tensor, with (C,) weight and bias of its dtype."""
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise ValueError("groupnorm_silu: x, weight, bias must be CUDA tensors")
    if not x.device == weight.device == bias.device:
        raise ValueError("groupnorm_silu: x, weight, bias on different devices")
    if x.dtype not in _DTYPE_CODES or not x.dtype == weight.dtype == bias.dtype:
        raise ValueError(f"groupnorm_silu: dtypes {x.dtype}/{weight.dtype}/"
                         f"{bias.dtype}; the kernel takes float32 or bfloat16 "
                         f"throughout")
    if x.dim() != 4:
        raise ValueError(f"groupnorm_silu: needs (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    B, C, H, W = x.shape
    if num_groups < 1 or C % num_groups:
        raise ValueError(f"groupnorm_silu: {C} channels do not split into "
                         f"{num_groups} groups")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"groupnorm_silu: weight {tuple(weight.shape)} and "
                         f"bias {tuple(bias.shape)}, expected ({C},)")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("groupnorm_silu: x, weight, bias must be contiguous")
    lib = _kernels.library()
    nbytes = lib.sdvg_groupnorm_silu_workspace(B, C, H * W, num_groups)
    if nbytes <= 0:
        raise ValueError(f"groupnorm_silu: shape {tuple(x.shape)} in "
                         f"{num_groups} groups is outside the kernel's limits "
                         f"(B * groups <= 65535, (C / groups) * H * W < 2^31)")
    out = torch.empty_like(x)
    work = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdvg_groupnorm_silu(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            work.data_ptr(), B, C, H * W, num_groups, float(eps), int(silu),
            _DTYPE_CODES[x.dtype], stream)
    _kernels.check(err, "groupnorm_silu")
    _kernels.count_launch("groupnorm_silu")
    return out


def group_norm(norm: nn.GroupNorm, x, silu: bool, force: str | None = None):
    """Dispatch ``norm`` (its groups, eps, weight and bias) on NCHW ``x``,
    followed by SiLU when ``silu``: the kernel for CUDA tensors; the plain
    version on the CPU and with ``force='reference'`` or under
    ``_kernels.force_reference``."""
    if force not in (None, "reference"):
        raise ValueError(f"group_norm: unknown force={force!r}")
    _kernels.record("groupnorm_silu", (tuple(x.shape), x.dtype,
                                       norm.num_groups, norm.eps, silu))
    args = (norm.weight, norm.bias, norm.num_groups, norm.eps, silu)
    if x.device.type == "cpu" or force or _kernels.forced():
        return groupnorm_silu_reference(x, *args)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no path for device {x.device}")
    return groupnorm_silu(x.contiguous(), *args)
