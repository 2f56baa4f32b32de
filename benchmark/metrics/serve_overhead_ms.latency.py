"""The median over the window's untraced requests of the client's latency
less the server's own (the reply's ``latency_s``): the socket, the framing
and the serving loop."""
from benchmark.metrics._readers import median_of

BETTER = "lower"
UNIT, SOURCE = "ms", "program_span"
LAYER = "serving loop, predict/serve.py"
MOVES, WORKLOADS = "latency_p90_ms", ["sd14_refine_b1_serve"]


def read(run):
    return median_of(run, "serve_overhead_ms")
