"""Tracing and profiling: the port's one module for both.

  - ``span(name)``: a host range. With no profiler running in the process
    it is one check and a shared null context (no clock read, no
    allocation). Under a profiler it is a ``torch.profiler.record_function``
    range: it lands in the profiler's events on the clock of the device's
    activity, and nesting gives its parent. The spans of the hot paths:
    ``serve.request`` (the client's round trip), ``serve.recv`` /
    ``serve.run`` / ``serve.send`` (the server's side of a request),
    ``predict.h2d`` (the frames' host-to-device copy), ``jit.<name>`` (a
    compiled program's call: input copies, replay, output clones),
    ``train.step`` (a training step on the host, feed to losses) with
    ``train.feed`` (the batch's copy to the device) and ``train.losses``
    inside it.
  - ``mark(stage, device)``: a device stage mark, the empty kernel
    ``sdvg_mark_<stage>`` (``csrc/stage_marks.cu``) on the current stream.
    A host range inside a function that ``utils/jit.py`` captures runs once,
    at the capture; a mark is device work, so the capture puts it into the
    graph and every replay runs it. A stage runs from its mark to the next;
    a program ends with ``end``. The programs' marks, in order:
    ``predict_impl``: ``vae`` (the context's encode), then for each
    predicted frame ``rollout`` (the transformer), ``vae`` (the refiner's
    decode, upscale and encode), ``unet`` (the UNet calls and the
    scheduler), ``vae`` (decode, downscale, encode); ``decode_impl``:
    ``vae``; ``step_impl``: ``forward`` (forward and losses), ``backward``,
    ``exchange`` (the gradients' all-reduce, over a data axis only),
    ``optimizer``; each then ``end``. Off the card a mark does nothing.
    The launch accounting (``_kernels.LAUNCHES``) does not count marks.
  - ``trace(logdir)``: the operator's exporter, a ``torch.profiler`` trace
    of host and device over every thread (``profile_all_threads``: a
    server thread started before the profiler is seen too), written as a
    Chrome trace under ``logdir`` (``--trace_dir`` of the predict and
    training CLIs). Once the profiler has traced in a process, every later
    launch of that process costs the host more: take the timings that
    matter before the first trace.
  - ``StepTimer``: the host's wall time of each training step, taken
    around the ``train.step`` span.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _profiler

STAGES = ("vae", "rollout", "unet", "forward", "backward", "exchange",
          "optimizer", "end")   # the order of csrc/stage_marks.cu
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}
_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named ``name`` while a profiler runs; otherwise a
    shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def mark(stage: str, device: torch.device) -> None:
    """Launch the mark of ``stage`` (one of ``STAGES``) on ``device``'s
    current stream; nothing off the card."""
    index = _STAGE_INDEX.get(stage)
    if index is None:
        raise ValueError(f"mark: unknown stage {stage!r}; one of {STAGES}")
    if device.type != "cuda":
        return
    from sd_video_gen_tpu_torch.ops import _kernels
    lib = _kernels.library()
    with torch.cuda.device(device):
        err = lib.sdvg_stage_mark(
            index, torch.cuda.current_stream(device).cuda_stream)
    _kernels.check(err, f"mark({stage})")


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the block over every thread and write its Chrome trace to
    ``logdir/trace.json`` (``trace_rank<r>.json`` in a process group of
    more than one). ``logdir`` None: nothing is profiled."""
    if logdir is None:
        yield None
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        yield logdir
    dist = torch.distributed
    name = ("trace.json" if not (dist.is_available() and dist.is_initialized()
                                 and dist.get_world_size() > 1)
            else f"trace_rank{dist.get_rank()}.json")
    prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    """The host's wall time of each step: ``with timer.step():`` opens the
    ``train.step`` span and times the same stretch. The device runs behind
    the host, so this is the host's feed and enqueue of a step (and its
    waits, where a copy or a fetch waits for the device), not the device's
    step. ``summary()`` gives the mean, p50 and p95 in ms."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        with span("train.step"):
            t0 = time.perf_counter()
            yield
            self.times.append(time.perf_counter() - t0)

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
