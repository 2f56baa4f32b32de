"""The median over the traced requests of the device's idle ms inside the
client's ``serve.request`` span (connect to parsed reply): the host work a
request's latency pays for."""
from benchmark.metrics._spans import idle_ms_median

BETTER = "lower"
UNIT, SOURCE = "ms", "program_span"
LAYER = "serving loop, predict/serve.py"
MOVES, WORKLOADS = "latency_p90_ms", ["sd14_refine_b1_serve"]


def read(run):
    return idle_ms_median(run, "serve.request")
