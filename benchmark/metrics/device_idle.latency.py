"""The share of the traced window's wall that no device operation
covers."""
from benchmark.metrics._readers import device_idle

BETTER = "lower"
UNIT, SOURCE = "%", "device_trace"
LAYER = "device"
MOVES, WORKLOADS = "latency_p90_ms", ["sd14_refine_b1_serve"]


def read(run):
    return device_idle(run)
