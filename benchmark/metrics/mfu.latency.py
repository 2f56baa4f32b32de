"""The traced requests' or steps' useful operations as a share of the
cards' bf16 peak."""
from benchmark.metrics._readers import mfu

BETTER = "higher"
UNIT, SOURCE = "%", "device_trace"
LAYER = "whole request or step"
MOVES, WORKLOADS = "latency_p90_ms", ["sd14_refine_b1_serve"]


def read(run):
    return mfu(run)
