"""Device ms a request inside the refiner's ``unet`` stages (its UNet calls
and the scheduler's arithmetic), from the program's stage marks."""
from benchmark.metrics._spans import serving_marks, stage_ms_per_unit

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "refiner UNet, diffusion/refine.py and models/unet.py"
MOVES, WORKLOADS = "frames_per_s", ["sd14_refine_b8"]


def read(run):
    return stage_ms_per_unit(run, "unet", serving_marks(run))
