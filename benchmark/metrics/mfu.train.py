"""The traced requests' or steps' useful operations as a share of the
cards' bf16 peak."""
from benchmark.metrics._readers import mfu

BETTER = "higher"
UNIT, SOURCE = "%", "device_trace"
LAYER = "whole request or step"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return mfu(run)
