"""GroupNorm (+ optional SiLU): the hand-written CUDA kernels and their plain version.

Counterpart of ``sd_video_gen_tpu/ops/groupnorm.py``. Every GroupNorm of the
port's VAE and UNet goes through ``group_norm``: the resnet preambles (GN ->
SiLU) and ``conv_norm_out`` with SiLU, the VAE attention block's norm and the
UNet ``Transformer2D`` input norm without. The JAX models use flax
``GroupNorm`` + ``silu`` there; the arithmetic is the same.

The kernel has two bodies, chosen before launch from the tensor's strides
(``route``):

- ``nhwc``, for a (B, C, H, W) tensor dense in ``torch.channels_last`` (the
  layout of the port's VAE and UNet, and of the TPU kernel):
  ``csrc/groupnorm_silu_nhwc.cu``. A unit is a slice of whole groups of one
  batch element, all pixels. Cluster mode (one read, one launch): a thread
  block cluster holds the unit in shared memory; taken where the tensor is
  one wave of at most one block per SM, or several waves of clusters of at
  most 4 blocks (most UNet norms and the VAE's up to 64px). Streaming mode
  (two reads, two launches) for the rest: the VAE's norms from 128px up, and
  shapes such as (8, 960, 64, 64), which a cluster of 8 holds but runs no
  faster. ``nhwc_plan`` says which a shape gets.
- ``nchw``, for a contiguous tensor: ``csrc/groupnorm_silu.cu`` (a split
  reduction over each (batch, group): per-chunk mean and M2, merged per
  group, then one normalise pass; three launches).

Any other strides raise: a silent layout copy is the traffic the NHWC body
exists to remove. ``groupnorm_silu_reference`` is the plain version both are
held against; its output keeps the input's memory format.

Under a CUDA graph capture (``utils/jit.py``) the launch is the eager one:
its workspace comes from the graph's pool, ``nhwc_plan`` answers from the
cache its warm-up filled, and the cluster launch (``cudaLaunchKernelEx``)
and the streaming mode's two launches become kernel nodes of the graph.

Dispatch (``group_norm``): CPU tensors take the plain version, CUDA tensors
always take the kernel, and ``force='reference'`` or
``_kernels.force_reference`` send a call to the plain version. Any other
device raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch import nn

from sd_video_gen_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Launches of ``groupnorm_silu`` by body, beside its count in
# ``_kernels.LAUNCHES``: a run can show which body its path took.
ROUTE_LAUNCHES: collections.Counter = collections.Counter()
NHWC_MODES = {1: "cluster", 2: "streaming"}
_MODE_CODES = {None: 0, "cluster": 1, "streaming": 2}
_NHWC_PLANS: dict = {}   # (device, nhwc_plan's arguments) -> its result


def route(x) -> str:
    """The kernel body for a (B, C, H, W) tensor, from its strides:
    ``"nhwc"`` if it is dense in ``torch.channels_last``, ``"nchw"`` if it is
    contiguous, an error otherwise. Where both hold (C = 1, or H = W = 1) the
    memory is the same either way and the one-launch NHWC body takes it."""
    if x.dim() != 4:
        raise ValueError(f"group_norm: needs (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    if x.is_contiguous():
        return "nchw"
    raise ValueError(f"group_norm: shape {tuple(x.shape)} with strides "
                     f"{x.stride()} is neither contiguous nor dense in "
                     f"torch.channels_last; no layout copy is made here")


def groupnorm_silu_reference(x, weight, bias, num_groups: int,
                             eps: float = 1e-6, silu: bool = True):
    """(B, C, H, W) GroupNorm in f32 (two-pass variance), the per-channel
    affine, optional SiLU, output in x's dtype and memory format: the CPU
    path and the kernels' oracle."""
    B, C = x.shape[:2]
    g = x.float().reshape(B, num_groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = (g - mean).square().mean(dim=2, keepdim=True)
    n = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    out = n * weight.float().reshape(shape) + bias.float().reshape(shape)
    out = (out * torch.sigmoid(out) if silu else out).to(x.dtype)
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return out.contiguous(memory_format=torch.channels_last)
    return out


def nhwc_plan(B: int, C: int, HW: int, num_groups: int, dtype,
              aligned: bool = True, mode: str | None = None) -> dict:
    """How the NHWC body runs a channels-last (B, C, HW) input on the current
    CUDA device: ``mode`` (``"cluster"``: one read, one launch;
    ``"streaming"``: two of each), ``vector`` (elements per load),
    ``cluster`` (blocks per cluster), ``groups_per_unit``, ``blocks``
    (clusters in the grid, or blocks per unit of the streaming mode's first
    launch), ``tile_bytes`` of the shared-memory tile and the ``workspace``
    bytes the launch needs. Asked of the library once per device and
    signature. ``mode`` asks for one of the two where the library would
    choose by its rule (to time one against the other and to test each)."""
    key = (torch.cuda.current_device(), B, C, HW, num_groups, dtype, aligned,
           mode)
    plan = _NHWC_PLANS.get(key)
    if plan is None:
        info = (ctypes.c_int * 6)()
        nbytes = _kernels.library().sdvg_groupnorm_silu_nhwc_plan(
            B, C, HW, num_groups, _DTYPE_CODES[dtype], int(aligned),
            _MODE_CODES[mode], info)
        if nbytes == -2:
            raise RuntimeError("groupnorm_silu: the CUDA device does not "
                               "answer the query for its SM count")
        if nbytes < 0:
            raise ValueError(
                f"groupnorm_silu: channels-last shape ({B}, {C}, {HW}) in "
                f"{num_groups} groups, mode {mode}, is outside the NHWC "
                f"body's limits (B <= 65535, H * W <= 2^30, a unit slice of "
                f"at most 512 vectors, a tile that fits a cluster)")
        plan = dict(mode=NHWC_MODES[info[0]], vector=info[1], cluster=info[2],
                    groups_per_unit=info[3], blocks=info[4],
                    tile_bytes=info[5], workspace=nbytes)
        _NHWC_PLANS[key] = plan
    return plan


def groupnorm_silu(x, weight, bias, num_groups: int, eps: float = 1e-6,
                   silu: bool = True):
    """Launch the CUDA kernel on a (B, C, H, W) f32/bf16 CUDA tensor that is
    dense in ``torch.channels_last`` (the NHWC body) or contiguous (the NCHW
    body), with (C,) weight and bias of its dtype. The output has x's memory
    format."""
    return _launch(x, weight, bias, num_groups, eps, silu)


def _launch(x, weight, bias, num_groups: int, eps: float, silu: bool,
            nhwc_mode: str | None = None):
    """``groupnorm_silu``; ``nhwc_mode`` pins the NHWC body's mode as in
    ``nhwc_plan``, for the tests and timings of one mode against the other.
    Forward only: raises where autograd would have to pass through it
    (``_kernels.refuse_grad``)."""
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise ValueError("groupnorm_silu: x, weight, bias must be CUDA tensors")
    _kernels.refuse_grad("groupnorm_silu", x, weight, bias)
    if not x.device == weight.device == bias.device:
        raise ValueError("groupnorm_silu: x, weight, bias on different devices")
    if x.dtype not in _DTYPE_CODES or not x.dtype == weight.dtype == bias.dtype:
        raise ValueError(f"groupnorm_silu: dtypes {x.dtype}/{weight.dtype}/"
                         f"{bias.dtype}; the kernel takes float32 or bfloat16 "
                         f"throughout")
    body = route(x)
    B, C, H, W = x.shape
    if num_groups < 1 or C % num_groups:
        raise ValueError(f"groupnorm_silu: {C} channels do not split into "
                         f"{num_groups} groups")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"groupnorm_silu: weight {tuple(weight.shape)} and "
                         f"bias {tuple(bias.shape)}, expected ({C},)")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("groupnorm_silu: weight, bias must be contiguous")
    lib = _kernels.library()
    xp, wp, bp = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    with torch.cuda.device(x.device):
        if body == "nhwc":
            nbytes = nhwc_plan(B, C, H * W, num_groups, x.dtype,
                               (xp | wp | bp) % 16 == 0,
                               nhwc_mode)["workspace"]
        else:
            nbytes = lib.sdvg_groupnorm_silu_workspace(B, C, H * W,
                                                       num_groups)
            if nbytes <= 0:
                raise ValueError(f"groupnorm_silu: shape {tuple(x.shape)} in "
                                 f"{num_groups} groups is outside the "
                                 f"kernel's limits (B * groups <= 65535, "
                                 f"(C / groups) * H * W < 2^31)")
        out = torch.empty_like(x)       # keeps x's (dense) strides
        work_ptr = None
        if nbytes:
            work = torch.empty(nbytes // 4, dtype=torch.float32,
                               device=x.device)
            work_ptr = work.data_ptr()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if body == "nhwc":
            err = lib.sdvg_groupnorm_silu_nhwc(
                xp, wp, bp, out.data_ptr(), work_ptr, nbytes, B, C, H * W,
                num_groups, float(eps), int(silu), _DTYPE_CODES[x.dtype],
                _MODE_CODES[nhwc_mode], stream)
        else:
            err = lib.sdvg_groupnorm_silu(
                xp, wp, bp, out.data_ptr(), work_ptr, B, C, H * W, num_groups,
                float(eps), int(silu), _DTYPE_CODES[x.dtype], stream)
    _kernels.check(err, f"groupnorm_silu ({body})")
    _kernels.count_launch("groupnorm_silu")
    ROUTE_LAUNCHES[body] += 1
    return out


def group_norm(norm: nn.GroupNorm, x, silu: bool, force: str | None = None):
    """Dispatch ``norm`` (its groups, eps, weight and bias) on (B, C, H, W)
    ``x``, channels-last or contiguous (``route``), followed by SiLU when
    ``silu``: the kernel for CUDA tensors; the plain version on the CPU and
    with ``force='reference'`` or under ``_kernels.force_reference``. The
    output has x's memory format."""
    if force not in (None, "reference"):
        raise ValueError(f"group_norm: unknown force={force!r}")
    _kernels.record("groupnorm_silu", (tuple(x.shape), x.dtype,
                                       norm.num_groups, norm.eps, silu,
                                       route(x)))
    args = (norm.weight, norm.bias, norm.num_groups, norm.eps, silu)
    if x.device.type == "cpu" or force or _kernels.forced():
        return groupnorm_silu_reference(x, *args)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no path for device {x.device}")
    return groupnorm_silu(x, *args)
