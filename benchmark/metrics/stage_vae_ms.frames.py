"""Device ms a request inside the ``vae`` stages: the context's encode,
the refiner's passes at 64px and 512px and the reply's decode, from the
program's stage marks."""
from benchmark.metrics._spans import serving_marks, stage_ms_per_unit

BETTER = "lower"
UNIT, SOURCE = "ms", "device_trace"
LAYER = "codec and refiner VAE, diffusion/vae_codec.py and models/vae.py"
MOVES, WORKLOADS = "frames_per_s", ["sd14_refine_b8"]


def read(run):
    return stage_ms_per_unit(run, "vae", serving_marks(run))
