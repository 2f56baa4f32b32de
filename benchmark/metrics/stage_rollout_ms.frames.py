"""Device ms a request inside the ``rollout`` stages (the transformer's
forward for each predicted frame), from the program's stage marks."""
from benchmark.metrics._spans import serving_marks, stage_ms_per_unit

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "rollout, ops/rollout.py and models/transformer.py"
MOVES, WORKLOADS = "frames_per_s", ["sd14_refine_b8"]


def read(run):
    return stage_ms_per_unit(run, "rollout", serving_marks(run))
