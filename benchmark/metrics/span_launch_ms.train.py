"""The median host ms of a step's ``jit.step_impl`` span: the compiled
step's call (input copies, the graph's launch, output clones)."""
from benchmark.metrics._spans import span_ms_median

BETTER = "lower"
UNIT, SOURCE = "ms", "program_span"
LAYER = "entry points and compiled programs, utils/jit.py"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return span_ms_median(run, "jit.step_impl")
