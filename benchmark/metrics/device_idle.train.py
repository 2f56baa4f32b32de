"""The share of the traced window's wall that no device operation
covers."""
from benchmark.metrics._readers import device_idle

BETTER = "lower"
UNIT, SOURCE = "%", "device_trace"
LAYER = "device"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return device_idle(run)
