"""What the per-layer metric readers share. A reader returns None where
its run holds nothing to read (no trace, no work count, a kernel that did
not run); the harness then leaves the metric out of the line."""

from __future__ import annotations

import statistics

from benchmark import roofline
from benchmark.trace import K1_PATTERNS, K2_PATTERNS

ELEMENT = {"bf16": 2, "bf16_full": 2, "f32": 4}
# One kernel of each K2 call: the NHWC body's single-pass launch, or the
# first of its streaming pair.
K2_CALL_PATTERNS = ("gn_nhwc_cluster", "gn_nhwc_stats")


def _ready(run) -> bool:
    return run.trace is not None and run.work is not None


def kernel_roofline(run, kernel: str):
    """K1's or K2's share of its roofline over the traced stretch, in
    percent: the least time of the calls the cell's shapes imply, over the
    kernel's device time. None unless the trace holds exactly those
    calls."""
    if not _ready(run):
        return None
    t, w = run.trace, run.work
    elem = ELEMENT[run.config["precision"]]
    if kernel == "k1":
        calls, least = w.k1_calls(), w.k1_least_s(elem)
        launched = t.count_matching(K1_PATTERNS)
        measured = t.seconds_matching(K1_PATTERNS)
    else:
        calls, least = w.k2_calls(), w.k2_least_s(elem)
        launched = t.count_matching(K2_CALL_PATTERNS)
        measured = t.seconds_matching(K2_PATTERNS)
    expected = sum(calls.values()) * t.units
    if launched != expected:
        print(f"{kernel}_roofline: the trace holds {launched} calls, the "
              f"shapes imply {expected}: not read", flush=True)
        return None
    return roofline.share(least * t.units, measured)


def mfu(run):
    """The useful operations of the traced units over the window's length
    at the bf16 peak of every card used, in percent."""
    if not _ready(run):
        return None
    return 100.0 * run.work.flops * run.trace.units / (
        run.trace.window_s * roofline.BF16_FLOPS * run.chips)


def device_idle(run):
    """The traced window's idle share; across chips, the worst rank's."""
    if run.trace is None:
        return None
    ranks = run.counters.get("ranks") or [{"idle": run.trace.idle_share()}]
    return 100.0 * max(r["idle"] for r in ranks)


def collectives_ms_per_unit(run):
    """Device ms a unit of the collectives' kernels on the slowest rank."""
    ranks = run.counters.get("ranks")
    if run.trace is None or not ranks:
        return None
    s = max(r["collectives_s"] for r in ranks)
    return 1e3 * s / run.trace.units if s > 0 else None


def bucket_ms_per_unit(run, patterns):
    if run.trace is None:
        return None
    s = run.trace.seconds_matching(patterns)
    return 1e3 * s / run.trace.units if s > 0 else None


def median_of(run, counter: str):
    values = run.counters.get(counter) or []
    return statistics.median(values) if values else None
