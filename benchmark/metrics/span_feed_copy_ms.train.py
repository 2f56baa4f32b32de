"""The median over a step's ``train.feed`` spans of the device ms of the
host-to-device copies that start inside each: the batch's pageable copy
itself. The span's host time is mostly the host's wait for the step before
(the copy queues behind its graph), so it would move with the device step;
the copy's own device time does not."""
from benchmark.metrics._spans import ops_ms_median

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "host feed, train/trainer.py Trainer.train_loop"
MOVES, WORKLOADS = "train_clips_per_s", ["train_b6"]


def read(run):
    return ops_ms_median(run, "train.feed", "memcpy htod")
