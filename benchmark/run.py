"""Run one cell of the benchmark on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by name
(``harness.py``); the run makes its weights and inputs from ``--seed``,
warms up every shape it uses, measures for ``--seconds`` (``--trace 1``:
profiles a bounded stretch of it and reports the per-layer metrics), then
compares what the timed path produced with the plain reference. The last
lines on standard error are each compared number beside its limit; the
last line on standard output is the result, one JSON object.

Exit codes: 0 with a result (``correct`` true or false); 3 without a card
or with fewer cards than the cell asks for; 4 where the process holds JAX
or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402

# The program's build and kernel caches, at fixed paths in the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton", "CUDA_CACHE_PATH": "build/nv"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = harness.HERE.parent
    for var, rel in CACHES.items():
        os.environ[var] = str(root / rel)
    run = harness.load_run(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < run.chips):
        print(f"benchmark: the cell {args.workload} needs {run.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    harness.driver(run.cell["driver"]).run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window",
              file=sys.stderr)
        return 4
    out = harness.result(run, torch.cuda.get_device_name(0))
    sys.stdout.flush()
    if run.trace is not None:
        for k in run.trace.top_kernels():
            print("kernel %.6f s %d %s %s" % k, file=sys.stderr)
    for line in harness.check_lines(run):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
