"""Plain attention, GroupNorm and dropout, the shape recorder the
benchmark's work counts read, and the lowered-precision control."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# Set by ``recording``: a list that every attention and GroupNorm call
# appends its kind and shape to (the work counts of ``benchmark.roofline``).
_RECORD: list = []


@contextlib.contextmanager
def recording():
    """Collect ``("attention", BH, Tq, Tk, d)`` and ``("group_norm", B, C,
    H, W)`` for every call made inside."""
    calls: list = []
    _RECORD.append(calls)
    try:
        yield calls
    finally:
        _RECORD.pop()


def _note(*entry) -> None:
    if _RECORD:
        _RECORD[-1].append(entry)


def attention(q, k, v, scale: float):
    """(BH, Tq, d) x (BH, Tk, d) attention, softmax in float32."""
    _note("attention", q.shape[0], q.shape[1], k.shape[1], q.shape[2])
    logits = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w, v.float()).to(q.dtype)


def group_norm(norm: torch.nn.GroupNorm, x, silu: bool):
    """GroupNorm in float32 (two-pass variance), affine, optional SiLU."""
    _note("group_norm", *x.shape)
    B, C = x.shape[:2]
    g = x.float().reshape(B, norm.num_groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = (g - mean).square().mean(dim=2, keepdim=True)
    n = ((g - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    out = n * norm.weight.float().reshape(shape) + norm.bias.float().reshape(
        shape)
    return (F.silu(out) if silu else out).to(x.dtype)


def causal_mask(size: int, device=None) -> torch.Tensor:
    m = torch.full((size, size), float("-inf"), device=device)
    return torch.triu(m, diagonal=1)


class Dropout:
    """Inverted dropout drawn from ``generator`` (None: no dropout), one
    ``bernoulli_`` a site in forward order, as the measured step draws."""

    def __init__(self, p: float, generator):
        self.p, self.generator = p, generator

    def __call__(self, x):
        if self.generator is None:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


def round_fp8(x: torch.Tensor,
              fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to the float8 format ``fmt`` under one scale (its
    largest magnitude to the format's largest finite value), back in its
    dtype; the gradient passes straight through."""
    if not x.is_floating_point():
        return x
    with torch.no_grad():
        s = (x.detach().abs().amax().float().clamp_min(1e-30)
             / torch.finfo(fmt).max)
        r = ((x.detach().float() / s).to(fmt).float() * s).to(x.dtype)
    return x + (r - x).detach() if x.requires_grad else r


class _GradFP8(torch.autograd.Function):
    """The identity forward; backward, the incoming gradient rounded to
    float8 e5m2, the format FP8 training keeps gradients in."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return round_fp8(grad, torch.float8_e5m2)


_PRODUCTS = {F.linear: (0, 1), F.conv2d: (0, 1), torch.matmul: (0, 1),
             torch.bmm: (0, 1), torch.Tensor.matmul: (0, 1),
             torch.Tensor.__matmul__: (0, 1)}


class lowered(TorchFunctionMode):
    """Inside: every product (linear, convolution, matmul, einsum) run as
    FP8 training runs it: its operands rounded to float8 e4m3 before it
    runs, and the gradient that reaches its output in the backward pass
    rounded to float8 e5m2 before the backward's products take it;
    accumulation stays float32. ``mode`` names the precision; "fp8" is the
    one there is."""

    def __init__(self, mode: str = "fp8"):
        super().__init__()
        if mode != "fp8":
            raise ValueError(f"lowered: unknown precision {mode!r}")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum:
            eq, *ops = args
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = list(ops[0])
            out = func(eq, *[round_fp8(o) for o in ops], **kwargs)
        elif func in _PRODUCTS:
            args = list(args)
            for i in _PRODUCTS[func]:
                if i < len(args) and isinstance(args[i], torch.Tensor):
                    args[i] = round_fp8(args[i])
            out = func(*args, **kwargs)
        else:
            return func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out = _GradFP8.apply(out)
        return out
