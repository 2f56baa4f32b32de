"""(BH, T, d) attention: the hand-written CUDA flash kernel and its plain version.

Counterpart of ``sd_video_gen_tpu/ops/attention.py``. The SD UNet's and VAE's
spatial self-attention (up to 4096 tokens at 512px) go through
``flash_attention``, which launches ``csrc/flash_attention.cu`` (online
softmax over key tiles, O(T) memory); ``reference_attention`` is the plain
einsum -> f32 softmax -> einsum version it is held against.

Dispatch (``attention``): CPU tensors take the plain version; CUDA tensors
with ``q.shape == k.shape`` always take the kernel. Cross-attention (77
context tokens) stays plain, as in the JAX package. The TPU-measured dispatch
table of the JAX package is not carried over: its numbers say nothing about
this card.
"""

from __future__ import annotations

import torch

from sd_video_gen_tpu_torch.ops import _kernels

MAX_HEAD_DIM = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORCE: list = []


def reference_attention(q, k, v, scale: float | None = None):
    """Einsum attention in f32: the CPU path and the kernel's oracle."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: float | None = None):
    """Launch the CUDA kernel on contiguous (BH, T, d) f32/bf16 CUDA tensors."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must be CUDA tensors")
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
    lib = _kernels.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdvg_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, T, d, float(scale), _DTYPE_CODES[q.dtype], stream)
    _kernels.check(err, "flash_attention")
    _kernels.count_launch("flash_attention")
    return out


class force_reference:
    """Context manager sending every ``attention`` call in this process to
    the plain version: the on-card comparison of a whole model with and
    without the kernel."""

    def __enter__(self):
        _FORCE.append("reference")
        return self

    def __exit__(self, *exc):
        _FORCE.pop()
        return False


def attention(q, k, v, scale: float | None = None, force: str | None = None):
    """Dispatch (BH, T, d) attention: the kernel for CUDA self-attention; the
    plain version on the CPU, for cross-attention, and with
    ``force='reference'`` or under ``force_reference``."""
    if force not in (None, "reference"):
        raise ValueError(f"attention: unknown force={force!r}")
    if (q.device.type == "cpu" or force or _FORCE
            or q.shape != k.shape):
        return reference_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no path for device {q.device}")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale)
