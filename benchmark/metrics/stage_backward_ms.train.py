"""Device ms a step inside the ``backward`` stage (``torch.autograd.grad``),
from the program's stage marks."""
from benchmark.metrics._spans import stage_ms_per_unit, train_marks

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "backward, train/trainer.py step_impl"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return stage_ms_per_unit(run, "backward", train_marks(run))
