"""K1's share of its roofline over the traced requests."""
from benchmark.metrics._readers import kernel_roofline

BETTER = "higher"
UNIT, SOURCE = "%", "device_trace"
LAYER = "kernel K1, ops/attention.py and csrc/flash_attention.cu"
MOVES, WORKLOADS = "frames_per_s", ["sd14_refine_b8"]


def read(run):
    return kernel_roofline(run, "k1")
