"""(BH, T, d) attention: the hand-written CUDA flash kernel and its plain version.

Counterpart of ``sd_video_gen_tpu/ops/attention.py``. The SD UNet's and VAE's
spatial self-attention (up to 4096 tokens at 512px) go through
``flash_attention``, which launches ``csrc/flash_attention.cu`` (online
softmax over key tiles, O(T) memory); ``reference_attention`` is the plain
einsum -> f32 softmax -> einsum version it is held against. ``route`` picks
the kernel's body by shape before launch: the tensor-core body (wgmma + TMA)
for bf16 where TMA can serve, the f32-FMA body otherwise.

Dispatch (``attention``): CPU tensors take the plain version; CUDA tensors
with ``q.shape == k.shape`` always take the kernel. Cross-attention (77
context tokens) stays plain, as in the JAX package. The TPU-measured dispatch
table of the JAX package is not carried over: its numbers say nothing about
this card.
"""

from __future__ import annotations

import collections

import torch

from sd_video_gen_tpu_torch.ops import _kernels

MAX_HEAD_DIM = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Launches of ``flash_attention`` by body, beside its count in
# ``_kernels.LAUNCHES``: a run can show which body its path took.
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


def route(dtype, d: int, data_ptrs) -> str:
    """The kernel body for (dtype, head dim, q/k/v data pointers): ``"wgmma"``
    (tensor cores, TMA loads) for bf16 with d a multiple of 8 and every
    pointer 16-byte aligned, which TMA needs (its row stride must be a
    multiple of 16 bytes); ``"fma"`` for everything else, f32 included
    (TF32 tensor cores would break the f32 tolerance)."""
    if (dtype == torch.bfloat16 and d % 8 == 0
            and all(p % 16 == 0 for p in data_ptrs)):
        return "wgmma"
    return "fma"


def reference_attention(q, k, v, scale: float | None = None):
    """Einsum attention in f32: the CPU path and the kernel's oracle."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: float | None = None):
    """Launch the CUDA kernel on contiguous (BH, T, d) f32/bf16 CUDA tensors.
    Forward only: raises where autograd would have to pass through it
    (``_kernels.refuse_grad``)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must be CUDA tensors")
    _kernels.refuse_grad("flash_attention", q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if q.dim() != 3 or not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention: needs equal (BH, T, d) shapes, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    BH, T, d = q.shape
    if not (1 <= BH <= 65535 and T >= 1 and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} outside "
                         f"BH <= 65535, T >= 1, d <= {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    scale = scale if scale is not None else d ** -0.5
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    body = route(q.dtype, d, ptrs)
    lib = _kernels.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if body == "wgmma":
            err = lib.sdvg_flash_attention_wgmma(
                *ptrs, out.data_ptr(), BH, T, d, float(scale), stream)
        else:
            err = lib.sdvg_flash_attention(
                *ptrs, out.data_ptr(), BH, T, d, float(scale),
                _DTYPE_CODES[q.dtype], stream)
    _kernels.check(err, f"flash_attention ({body})")
    _kernels.count_launch("flash_attention")
    ROUTE_LAUNCHES[body] += 1
    return out


def attention(q, k, v, scale: float | None = None, force: str | None = None):
    """Dispatch (BH, T, d) attention: the kernel for CUDA self-attention; the
    plain version on the CPU, for cross-attention, and with
    ``force='reference'`` or under ``_kernels.force_reference``."""
    if force not in (None, "reference"):
        raise ValueError(f"attention: unknown force={force!r}")
    if q.shape == k.shape:
        _kernels.record("flash_attention", (tuple(q.shape), q.dtype, scale))
    if (q.device.type == "cpu" or force or _kernels.forced()
            or q.shape != k.shape):
        return reference_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no path for device {q.device}")
    # no layout copy here: the launcher raises on a non-contiguous input,
    # and a caller that needs a copy makes it where it can be seen
    return flash_attention(q, k, v, scale)
