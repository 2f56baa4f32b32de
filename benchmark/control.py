"""The readings the correctness limits are set against, at a cell's own
sizes on the card: the plain reference computed in float8, the precision
below the configuration's bf16 (every product's operands in e4m3 and the
backward's gradients in e5m2; a training cell's parameters and Adam's
moments kept in e4m3 where the configuration keeps them in bf16), put in
the program's place and read by the cell's own comparison; for a
training cell also the reference
trained on half of each batch (the mean over the rest), and across chips
without the gradients' exchange (as rank 0 sees it), in the program's
place.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--fault fp8|half_batch]

Prints one JSON line a seed. A state left unchanged reads 1 by the
training comparison's measure and needs no run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from benchmark import harness
from benchmark import traffic as TR
from benchmark.drivers import _serving as S
from benchmark.drivers import train as T
from benchmark.reference.layers import lowered


def serving(run) -> dict:
    cfg, tr = run.config, run.traffic
    B, pred, k = (tr["clips_per_request"], tr["pred_frames"],
                  tr["check_requests"])
    frames = np.concatenate([TR.clips(tr, run.seed, i) for i in range(k)])
    models = S.reference_models(cfg, run.seed, run.device)
    noises = [torch.cat([n] * k) for n in S.noise_rows(
        cfg, run.seed, B, range(B), pred, run.device)]
    with lowered("fp8"):
        outs = S.reference_request(models, cfg, frames, noises, pred)
    return S.compare(models, cfg, frames, *outs, noises)


def training(run, fault: str) -> dict:
    cfg, ranks = run.config, run.chips
    batches = TR.train_batches(run.traffic, run.seed)
    fed = batches
    if fault == "half_batch":
        fed = [b[: len(b) // 2] for b in batches]
    with lowered("fp8") if fault == "fp8" else contextlib.nullcontext():
        prog = T.reference_steps(
            cfg, run.seed, run.device, fed, ranks=ranks,
            exchange=fault != "no_exchange",
            storage=torch.float8_e4m3fn if fault == "fp8" else None)
    numbers, readings = T.compare(cfg, run.seed, run.device, batches, prog,
                                  ranks)
    return dict(numbers, **readings)


def readings(run, fault: str = "fp8") -> dict:
    if run.cell["driver"] == "train":
        return training(run, fault)
    if fault != "fp8":
        raise ValueError(f"fault {fault!r} is a training cell's")
    return serving(run)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault", default="fp8",
                        choices=("fp8", "half_batch", "no_exchange"))
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.load_run(args.workload, seed, 0.0, False, t0)
        out = readings(run, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
