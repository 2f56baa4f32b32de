"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes of the two hand-written kernels' calls, and the useful work of a
request or a step counted on the plain reference.

Peaks: NVIDIA H100 SXM data sheet, dense, at its full 700 W.

K1 (flash attention) on (BH, Tq, d) queries and (BH, Tk, d) keys and
values: 4 * BH * Tq * Tk * d operations (the two products), and q, k and
v read once and the output written once. K2 (GroupNorm + SiLU) on x: one
read and one write of x; its arithmetic is a few operations an element,
far below the bandwidth bound. A call's least time is the larger of its
operations over the peak rate and its bytes over the peak bandwidth, and
a kernel's roofline share is the sum of its calls' least times over its
measured device time.

The work of a request or a step is counted on the plain reference at the
cell's own shapes on the meta device (no memory, no arithmetic): the
floating-point operations of its products (``FlopCounterMode``: matrix
products, convolutions, attention's products) and every attention and
GroupNorm call with its shape. A request's counts do not depend on what
implements it, so a share of the peak stays comparable when a kernel is
taken off the path.
"""

from __future__ import annotations

import collections
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.layers import recording

BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def k1_ops_bytes(bh: int, tq: int, tk: int, d: int, elem: int):
    return 4.0 * bh * tq * tk * d, float(elem * (2 * bh * tq * d
                                                 + 2 * bh * tk * d))


def k2_bytes(shape, elem: int) -> float:
    return 2.0 * elem * math.prod(shape)


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


class Work:
    """Operations and kernel calls of one unit (a request or a step):
    ``flops`` and a Counter of ``("attention", BH, Tq, Tk, d)`` and
    ``("group_norm", B, C, H, W)`` calls."""

    def __init__(self, flops: float = 0.0, calls=None):
        self.flops = float(flops)
        self.calls = collections.Counter(calls or {})

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.calls + other.calls)

    def __mul__(self, n: int) -> "Work":
        return Work(self.flops * n,
                    {k: v * n for k, v in self.calls.items()})

    __rmul__ = __mul__

    def k1_calls(self):
        """The calls K1 serves: self-attention (queries as many as keys)."""
        return {k: n for k, n in self.calls.items()
                if k[0] == "attention" and k[2] == k[3]}

    def k2_calls(self):
        return {k: n for k, n in self.calls.items() if k[0] == "group_norm"}

    def k1_least_s(self, elem: int) -> float:
        return sum(n * least_seconds(*k1_ops_bytes(*k[1:], elem))
                   for k, n in self.k1_calls().items())

    def k2_least_s(self, elem: int) -> float:
        return sum(n * least_seconds(0.0, k2_bytes(k[1:], elem))
                   for k, n in self.k2_calls().items())


def count(fn, *args, **kwargs) -> Work:
    """The work of ``fn(*args, **kwargs)`` run on meta tensors."""
    with recording() as calls, FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return Work(counter.get_total_flops(), collections.Counter(calls))


def share(least_s: float, measured_s: float):
    """A share of a bound in percent, or None where nothing was measured."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / measured_s


def meta_module(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)
