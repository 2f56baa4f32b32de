"""Tracing/profiling utilities (``sd_video_gen_tpu/utils/profiling.py``).

  - ``trace(logdir)``: a ``torch.profiler`` trace of host and device, written
    as a Chrome trace under ``logdir``. Once the profiler has traced in a
    process, every later launch of that process costs the host more: take
    the timings that matter before the first trace.
  - ``StepTimer``: wall-clock step timing, with a device synchronise on
    demand; its summary goes into the MetricsLogger stream.
  - ``annotate(name)``: an NVTX range, so that custom regions show up in
    traces (a no-op context without a CUDA build).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str = "sdvg_trace"):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


class StepTimer:
    """Accumulates step wall times; ``summary()`` gives mean/p50/p95 ms.

    Without a synchronise a step's time is the host's time to enqueue it
    (the device runs behind); ``stop(sync=True)`` waits for the device."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync: bool = False):
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> dict:
        if not self.times:
            return {}
        xs = sorted(self.times)
        n = len(xs)
        return {
            "step_ms_mean": 1e3 * sum(xs) / n,
            "step_ms_p50": 1e3 * xs[n // 2],
            "step_ms_p95": 1e3 * xs[min(n - 1, int(n * 0.95))],
            "steps_timed": n,
        }

    def reset(self):
        self.times.clear()
