"""The harness: finds a cell and everything it names by file, drives it,
and prints the run's result.

Everything that belongs to one configuration, traffic mix, cell, metric
or driver is a file of its own under ``benchmark/``, found by name:

  configs/<config>.json       widths, precision, source, assumed, reduced
  traffic/<traffic>.json      the generator's parameters (``traffic.py``)
  workloads/<cell>.json       config, traffic, driver, chips, why, limits
                              [, reports: metrics named here, not there]
  drivers/<driver>.py         ``run(run)``: set-up, window, the check
  end_to_end/<metric>.json    unit, better, bound, source[, workloads]
  metrics/<metric>.py         UNIT, BETTER, LAYER, MOVES, SOURCE,
                              WORKLOADS, read(run)

A later cell, configuration or metric is new files; ``manifest.py`` builds
``BENCHMARK.json`` from them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Top-level module names the measured run may not hold: the JAX package
# and JAX itself, compared whole (the port's name begins with the JAX
# package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "sd_video_gen_tpu")


def forbidden_modules(names=None) -> list:
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    layer: str
    moves: str
    source: str
    workloads: tuple
    read: object


def cells(root: Path = HERE) -> dict:
    return {p.stem: _json(p) for p in sorted((root / "workloads").glob(
        "*.json"))}


def configs(root: Path = HERE) -> dict:
    return {p.stem: _json(p) for p in sorted((root / "configs").glob(
        "*.json"))}


def end_to_end(root: Path = HERE) -> dict:
    return {p.stem: _json(p) for p in sorted((root / "end_to_end").glob(
        "*.json"))}


def per_layer(root: Path = HERE) -> dict:
    out = {}
    for p in sorted((root / "metrics").glob("*.py")):
        if p.name.startswith("_"):
            continue
        m = _module(p, f"benchmark_metric_{p.stem.replace('.', '_')}")
        out[p.stem] = Metric(p.stem, m.UNIT, m.BETTER, m.LAYER, m.MOVES,
                             m.SOURCE, tuple(m.WORKLOADS), m.read)
    return out


def driver(name: str, root: Path = HERE):
    return _module(root / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def reporters(metric: str, listed, root: Path = HERE) -> list:
    """The cells that report ``metric``: those its file lists
    (``listed``) and those whose own file names it under ``reports``, so
    that a later cell reports an existing metric without an edit."""
    return list(listed) + [n for n, c in cells(root).items()
                           if metric in c.get("reports", ())
                           and n not in listed]


def e2e_of(cell: str, root: Path = HERE) -> list:
    """The end-to-end metrics ``cell`` reports."""
    return [n for n, m in end_to_end(root).items()
            if "workloads" not in m
            or cell in reporters(n, m["workloads"], root)]


def layers_of(cell: str, root: Path = HERE) -> list:
    return [m for m in per_layer(root).values()
            if cell in reporters(m.name, m.workloads, root)]


def spread(values) -> float:
    """The distance between the first and third quartiles over the
    median (``statistics.quantiles``, n=4)."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / abs(statistics.median(values))


def percentile(values, p: float) -> float:
    """The ``p``-th percentile, nearest rank: the least value with at least
    ``p`` percent of the values at or below it (inf counts as a value)."""
    s = sorted(values)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


@dataclasses.dataclass
class Run:
    """One run of one cell: what the harness gives the driver, and what
    the driver and the metric readers leave in it."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    t_start: float
    device: str = "cuda"
    setup_s: float | None = None
    e2e: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    trace: object = None           # trace.Trace of the traced stretch
    counters: dict = dataclasses.field(default_factory=dict)
    work: object = None            # roofline.Work of one request or step
    memory_peak_bytes: int = 0

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])

    def check(self, name: str, value: float, limit) -> None:
        """A number the run compares with the reference, and its limit
        (None: not set yet, and the run is not correct)."""
        self.checks[name] = (float(value),
                             float("nan") if limit is None else float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())



def load_run(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, root: Path = HERE, device="cuda") -> Run:
    cell = _json(root / "workloads" / f"{name}.json")
    return Run(name, cell, _json(root / "configs" / f"{cell['config']}.json"),
               _json(root / "traffic" / f"{cell['traffic']}.json"), seed,
               seconds, traced, t_start, device)


def result(run: Run, card: str, root: Path = HERE) -> dict:
    """The result line: end-to-end metrics untraced, per-layer traced."""
    if run.traced:
        metrics = {}
        for m in layers_of(run.name, root):
            v = m.read(run)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    else:
        units = end_to_end(root)
        metrics = {n: {"value": float(run.setup_s if n == "setup_s"
                                      else run.e2e[n]),
                       "unit": units[n]["unit"]}
                   for n in e2e_of(run.name, root)}
    device = {"platform": "gpu", "kind": card, "count": run.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        t = run.trace
        ranks = run.counters.get("ranks") or [
            {"busy_s": t.busy_s(), "window_s": t.window_s}]
        device.update(busy_s=statistics.fmean(r["busy_s"] for r in ranks),
                      window_s=statistics.fmean(r["window_s"] for r in ranks))
        out["breakdown"] = {
            "device_ops": [[b, s] for b, s in
                           list(t.by_bucket().items())[:10]],
            "idle_gaps": t.idle_gaps(10)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def check_lines(run: Run) -> list:
    return [f"check {k}: {v!r} (limit {lim!r})"
            for k, (v, lim) in run.checks.items()] + [
        f"correct: {run.correct}"]
