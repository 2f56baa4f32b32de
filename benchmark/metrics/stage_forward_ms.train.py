"""Device ms a step inside the ``forward`` stage (the forward and the
losses), from the program's stage marks."""
from benchmark.metrics._spans import stage_ms_per_unit, train_marks

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "forward and losses, models/transformer.py and ops/losses.py"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return stage_ms_per_unit(run, "forward", train_marks(run))
