"""Closed-loop batched serving: one client sends requests back to back,
each of ``clips_per_request`` clips, through the port's compiled predict
and decode programs in this process (``_serving.request``).

Set-up builds the models from the seed, compiles the serving shape's
programs and replays them once. The window then serves requests until
``--seconds`` have passed since it opened and the last one has returned;
``frames_per_s`` is the predicted frames of every request completed over
the window's whole length. With ``--trace 1`` the first ``trace_units``
requests of the window run under the profiler, whose events are read once
the window has closed. Afterwards a sample of
``check_requests`` requests, drawn from the seed, is compared with the
plain reference (``_serving.compare``); a request that raised counts as
failed and fails the run.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import traffic as TR
from benchmark import weights
from benchmark.drivers import _serving as S
from benchmark.trace import WINDOW_SPAN, Tracer


def traced(units: int, body) -> Tracer:
    """``body()``, which serves ``units`` requests or runs ``units``
    steps, under the profiler, in the window span. Returns the stopped
    profiler, for the driver to read (``Tracer.trace``) once the window has
    closed: read inside it, the trace of 8 B=1 requests took about 30 s of
    a 40 s window."""
    from torch.profiler import record_function
    with Tracer(units) as tracer:
        torch.cuda.synchronize()
        with record_function(WINDOW_SPAN):
            body()
            torch.cuda.synchronize()
    return tracer


def repeat(fn, n: int):
    """A body that calls ``fn`` ``n`` times."""
    return lambda: [fn() for _ in range(n)]


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(run, served_records: list, batch: int) -> None:
    """Compare ``check_requests`` of the served records (frames, context,
    preds, imgs) of requests of ``batch`` clips, drawn from the seed, with
    the plain reference."""
    cfg, tr, lim = run.config, run.traffic, run.cell["limits"]
    pred = tr["pred_frames"]
    rng = np.random.default_rng(weights.mix(run.seed, "sample"))
    picks = sorted(rng.choice(len(served_records), min(
        tr["check_requests"], len(served_records)), replace=False))
    got = [served_records[i] for i in picks]
    models = S.reference_models(cfg, run.seed, run.device)
    noises = S.noise_rows(cfg, run.seed, batch, range(batch), pred,
                          run.device)
    noises = [torch.cat([n] * len(got)) for n in noises]
    nums = S.compare(models, cfg, np.concatenate([g[0] for g in got]),
                     torch.cat([g[1] for g in got]),
                     torch.cat([g[2] for g in got]),
                     np.concatenate([g[3] for g in got]), noises)
    for name, value in nums.items():
        run.check(name, value, lim[name])


def run(run) -> None:
    tr = run.traffic
    B, pred = tr["clips_per_request"], tr["pred_frames"]
    served = S.build_port(run.config, run.seed, run.device, pred)
    for i in (-2, -1):          # compile, then one replay
        S.request(served, TR.clips(tr, run.seed, i))
    records, failed = [], 0

    def serve_one():
        nonlocal failed
        frames = TR.clips(tr, run.seed, len(records) + failed)
        try:
            records.append((frames, *S.request(served, frames)))
        except Exception as e:      # a request that raised is missing
            print(f"request failed: {type(e).__name__}: {e}", flush=True)
            failed += 1

    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    tracer = (traced(tr["trace_units"], repeat(serve_one, tr["trace_units"]))
              if run.traced else None)
    while time.perf_counter() - t0 < run.seconds:
        serve_one()
    t_end = time.perf_counter()
    if tracer is not None:
        run.trace = tracer.trace()
    run.attempted, run.failed = len(records) + failed, failed
    run.e2e["frames_per_s"] = len(records) * B * pred / (t_end - t0)
    if torch.cuda.is_available():
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del served
    free()
    run.check("failed_requests", failed, 0)
    if run.traced:
        run.work = S.request_work(run.config, B, pred)
    check(run, records, B)
