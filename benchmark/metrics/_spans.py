"""What the stage and span readers share.

The program marks each stage of its compiled programs with an empty
kernel, ``sdvg_mark_<stage>`` (``utils/profiling.mark`` in the port), which
every replay of a graph runs on the device's timeline; a stage runs from
its mark to the next mark, and each program ends with ``end``. Its host
paths carry spans (``utils/profiling.span``), which the profiler records
as host operations on the same clock. A stage's device time is the busy
time (the union of the device operations) inside [its mark, the next
mark), so an idle gap does not count. A reader returns None where the
trace holds no marks or spans (a program without them) or not the count
that the traced units imply, as the K1 and K2 readers do for their calls.
The readers of marks are the files ``stage_*``, those of spans ``span_*``.
"""

from __future__ import annotations

import bisect
import collections
import statistics

MARK = "sdvg_mark_"


def serving_marks(run) -> dict:
    """The marks of one served request: ``predict_impl``'s (the context's
    encode, then per predicted frame the transformer, the refiner's two
    codec passes and its UNet, then the end) and ``decode_impl``'s."""
    p = run.traffic["pred_frames"]
    return {"vae": 2 * p + 2, "rollout": p, "unet": p, "end": 2}


def train_marks(run) -> dict:
    """The marks of one step of ``step_impl``; the exchange only across
    cards."""
    return {"forward": 1, "backward": 1, "exchange": int(run.chips > 1),
            "optimizer": 1, "end": 1}


def marks(trace) -> list:
    """(stage, start) of every mark inside the window, in order."""
    lo, hi = trace.window
    out = []
    for name, s, _ in trace.device_ops:
        i = name.find(MARK)
        if i >= 0 and lo <= s < hi:
            stage = name[i + len(MARK):]
            out.append((stage.split("(")[0].strip(), s))
    return out


def _busy_to(trace):
    """t -> device busy microseconds in [window start, t)."""
    merged = trace.busy_intervals()
    starts = [s for s, _ in merged]
    before = [0.0]
    for s, e in merged:
        before.append(before[-1] + e - s)

    def busy(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0.0
        s, e = merged[i]
        return before[i] + min(t, e) - s
    return busy


def stage_busy_s(trace) -> dict:
    """Device busy seconds inside each stage over the window."""
    ms = marks(trace)
    busy = _busy_to(trace)
    ends = [s for _, s in ms[1:]] + [trace.window[1]]
    out: dict = collections.defaultdict(float)
    for (stage, s), e in zip(ms, ends):
        out[stage] += (busy(e) - busy(s)) / 1e6
    return dict(out)


def stage_ms_per_unit(run, stage: str, per_unit: dict):
    """Device ms a request or step inside ``stage``; None unless the
    window holds ``per_unit`` marks of each stage for every unit."""
    if run.trace is None:
        return None
    t = run.trace
    found = collections.Counter(s for s, _ in marks(t))
    implied = {k: n * t.units for k, n in per_unit.items() if n}
    if found != implied:
        print(f"{stage}: the trace holds the marks {dict(found)}, the "
              f"program implies {implied}: not read", flush=True)
        return None
    return 1e3 * stage_busy_s(t).get(stage, 0.0) / t.units


def spans(trace, name: str) -> list:
    """(start, end) of every host span ``name`` inside the window."""
    lo, hi = trace.window
    return [(s, e) for n, s, e in trace.host_ops
            if n == name and lo <= s and e <= hi]


def _one_a_unit(run, name: str):
    if run.trace is None:
        return None
    got = spans(run.trace, name)
    if len(got) != run.trace.units:
        print(f"{name}: the trace holds {len(got)} spans for "
              f"{run.trace.units} units: not read", flush=True)
        return None
    return got


def span_ms_median(run, name: str):
    """The median host ms of the span ``name``, one a unit."""
    got = _one_a_unit(run, name)
    if got is None:
        return None
    return statistics.median(e - s for s, e in got) / 1e3


def idle_ms_median(run, name: str):
    """The median over the spans ``name``, one a unit, of the device's
    idle ms inside each."""
    got = _one_a_unit(run, name)
    if got is None:
        return None
    busy = _busy_to(run.trace)
    return statistics.median((e - s) - (busy(e) - busy(s))
                             for s, e in got) / 1e3


def ops_ms_median(run, name: str, pattern: str):
    """The median over the spans ``name``, one a unit, of the device ms of
    the operations whose name holds ``pattern`` (any case) and that start
    inside each; None where a span holds none."""
    got = _one_a_unit(run, name)
    if got is None:
        return None
    pat = pattern.lower()
    ops = [(s, e) for n, s, e in run.trace.device_ops if pat in n.lower()]
    starts = [s for s, _ in ops]
    per = []
    for s, e in got:
        inside = ops[bisect.bisect_left(starts, s):
                     bisect.bisect_right(starts, e)]
        if not inside:
            print(f"{name}: a span holds no {pattern!r} operation: not "
                  f"read", flush=True)
            return None
        per.append(sum(oe - os for os, oe in inside))
    return statistics.median(per) / 1e3
