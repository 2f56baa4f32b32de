"""Device ms a step of the optimizer's kernels (Adam's foreach passes)."""
from benchmark.metrics._readers import bucket_ms_per_unit
from benchmark.trace import BUCKETS

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "optimizer, train/optim.py"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return bucket_ms_per_unit(run, dict(BUCKETS)["optimizer"])
