"""The device trace of a run's traced stretch, and what it reduces to.

``Tracer`` runs ``torch.profiler`` (host and CUDA activities) around a
bounded stretch of steady requests or steps, marked by the span
``bench.window``; the benchmark marks each request or step with its own
span. ``Trace`` holds the device operations (kernels, copies, sets) as
intervals on the profiler's clock, and gives the busy time (the union of
the intervals inside the window), the idle share, the device time of
kernels matching given name patterns, the time by bucket, and the longest
idle gaps with what the host was doing in each.

The buckets (first match wins) are those of the port's earlier profile
table with two corrections: Adam's ``multi_tensor_apply_kernel`` is the
optimizer, and a bare ``xmma`` names a product, not a convolution:
cuBLAS's ``sm80_xmma_gemm`` and ``gemmSN`` kernels are products, while
cuDNN's convolutions name ``fprop``, ``dgrad``, ``wgrad`` or
``implicit_gemm``.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time

BUCKETS = (
    ("K1 flash attention", ("flash_fwd",)),
    ("K2 GroupNorm+SiLU", ("gn_nhwc", "gn_partial", "gn_stats", "gn_apply")),
    ("optimizer", ("multi_tensor_apply_kernel",)),
    ("collectives", ("nccl",)),
    ("NCHW<->NHWC transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolutions", ("conv2d", "convolution", "cudnn", "fprop", "dgrad",
                      "wgrad", "implicit_gemm", "conv_")),
    ("matrix products", ("gemm", "nvjet", "cublas", "gemv", "xmma")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("softmax", ("softmax",)),
    ("copies / cat", ("copy", "catarray", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "reduce")),
)
K1_PATTERNS = BUCKETS[0][1]
K2_PATTERNS = BUCKETS[1][1]
WINDOW_SPAN = "bench.window"


def bucket_of(name: str) -> str:
    key = name.lower()
    return next((b for b, words in BUCKETS if any(w in key for w in words)),
                "other")


@dataclasses.dataclass
class Trace:
    device_ops: list          # (name, start_us, end_us), sorted by start
    host_ops: list            # (name, start_us, end_us) of the host thread(s)
    window: tuple             # (start_us, end_us)
    units: int                # requests or steps inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _inside(self):
        lo, hi = self.window
        for name, s, e in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield name, s, e

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e in sorted(self._inside(), key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def seconds_matching(self, patterns) -> float:
        pats = tuple(p.lower() for p in patterns)
        return sum(e - s for name, s, e in self._inside()
                   if any(p in name.lower() for p in pats)) / 1e6

    def count_matching(self, patterns) -> int:
        pats = tuple(p.lower() for p in patterns)
        return sum(1 for name, _, _ in self._inside()
                   if any(p in name.lower() for p in pats))

    def top_kernels(self, n: int = 15) -> list:
        """(seconds, launches, bucket, name) of the ``n`` kernels that
        took most device time, by name."""
        acc: dict = {}
        for name, s, e in self._inside():
            t, c = acc.get(name, (0.0, 0))
            acc[name] = (t + (e - s) / 1e6, c + 1)
        return sorted(((t, c, bucket_of(k), k[:100])
                       for k, (t, c) in acc.items()), reverse=True)[:n]

    def by_bucket(self) -> dict:
        out: dict = {}
        for name, s, e in self._inside():
            b = bucket_of(name)
            out[b] = out.get(b, 0.0) + (e - s) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps with no device operation, each named by
        the innermost host operation running at its middle."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        starts = [s for _, s, _ in self.host_ops]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            best = None
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                name, s, e = self.host_ops[j]
                if e >= mid:
                    best = name
                    break
                if mid - s > 60e6:
                    break
            out.append([best or "no host operation", length / 1e6])
        return out


class Tracer:
    """``torch.profiler`` over host and CUDA activities around ``units``
    requests or steps; ``trace()`` reads it once stopped. Reading the
    events takes tens of seconds for a stretch of a few hundred thousand
    device operations, so the drivers read it after the window closes."""

    def __init__(self, units: int):
        from torch.profiler import ProfilerActivity, profile
        self.units = units
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        self.prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t
        return False

    def trace(self) -> Trace:
        from torch.autograd import DeviceType
        t = time.perf_counter()
        device, host, window = [], [], None
        for e in self.prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                device.append(span)
            elif e.name == WINDOW_SPAN:
                window = span[1:]
            else:
                host.append(span)
        if window is None:
            raise RuntimeError(f"trace: no {WINDOW_SPAN} span")
        # a host span's mirror on the device timeline is no device work
        names = {h[0] for h in host} | {WINDOW_SPAN}
        device = [d for d in device if d[0] not in names]
        device.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        print(f"trace: {len(device)} device operations, profiler stopped "
              f"in {self.stop_s:.3f} s, read in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        return Trace(device, host, window, self.units)
