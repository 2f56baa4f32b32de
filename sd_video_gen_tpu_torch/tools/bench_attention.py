"""Flash attention (K1) on the card: a parity check, then its time against
the plain version (``tools/bench_attention.py`` beside the JAX package, on
the port's dispatcher).

The shapes are the SD spatial-attention hot spots at 512px, as in the JAX
tool:
  (8, 4096, 40)  - UNet down_0 attention, batch 1, 8 heads of 40 (320 ch)
  (8, 1024, 80)  - UNet down_1 attention
  (1, 4096, 512) - VAE mid attention (one head of 512)
each in float32 and bfloat16. ``flash`` is ``ops/attention.attention``, the
dispatcher the models call: on the card it launches
``csrc/flash_attention.cu`` on the body ``attention.route`` picks (``wgmma``
for bf16, ``tf32x3`` for f32); on the CPU it is the plain version.
``einsum`` is the plain version (``reference_attention``); ``sdpa`` is
``F.scaled_dot_product_attention`` on the same inputs, a yardstick only (the
port never calls it).

Parity first: the dispatcher against the plain version on the same inputs,
within the port's limits (f32 3e-5, the three-TF32-product body's limit;
bf16 2e-2, the kernel tests' limit), not the JAX tool's TPU-kernel limits.
Timing: ``REPEATS`` calls chained through a data dependence (each output is
the next query), as the JAX tool's scan; one warm-up chain, then the best of
``TIMED_CHAINS`` chains, each closed by CUDA events (on the CPU, the host
clock).

    python -m sd_video_gen_tpu_torch.tools.bench_attention [--device cpu]

One JSON line per (shape, dtype, impl) with ``per_call_us``, a parity line
and a speedup line per (shape, dtype). The exit code is 1 if a parity check
failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.config import strict_f32
from sd_video_gen_tpu_torch.ops.attention import (attention,
                                                  reference_attention, route)

SHAPES = [(8, 4096, 40), (8, 1024, 80), (1, 4096, 512)]
REPEATS = 8
TIMED_CHAINS = 3
DTYPES = (torch.float32, torch.bfloat16)
# |dispatcher - plain| limits: the tf32x3 body's (3x its worst reading on
# the card) and the bf16 kernel tests' (p and the output rounded to bf16).
ATOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


def sdpa(q, k, v):
    """torch's fused attention on (1, BH, T, d), so that its fused backends
    may take it."""
    return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]


IMPLS = {"flash": attention, "einsum": reference_attention, "sdpa": sdpa}


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def inputs(shape, dtype, device, seed: int):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)).to(device,
                                                                 dtype)
                 for _ in range(3))


def parity(shape, dtype, device) -> dict:
    q, k, v = inputs(shape, dtype, device, 1)
    out = attention(q, k, v)
    err = float((out.float() - reference_attention(q, k, v).float())
                .abs().max())
    body = (route(dtype, shape[-1], (q.data_ptr(), k.data_ptr(),
                                     v.data_ptr()))
            if q.is_cuda else "plain")
    return {"parity_shape": list(shape), "dtype": dtype_name(dtype),
            "max_abs_err": err, "atol": ATOL[dtype], "ok": err <= ATOL[dtype],
            "route": body}


def per_call_us(fn, shape, dtype, device) -> float:
    """The best of ``TIMED_CHAINS`` chains of ``REPEATS`` calls, each call's
    output the next call's query, after one warm-up chain: us a call."""
    q, k, v = inputs(shape, dtype, device, 0)
    on_card = torch.device(device).type == "cuda"

    def chain():
        o = q
        for _ in range(REPEATS):
            o = fn(o, k, v)
        return o

    chain()
    best = float("inf")
    for _ in range(TIMED_CHAINS):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best / REPEATS


def emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def run(device="cuda", shapes=SHAPES, dtypes=DTYPES) -> list:
    """Every (shape, dtype): the parity line, one line per impl, the
    speedup line; printed and returned."""
    lines = []
    with torch.inference_mode():
        for shape in shapes:
            for dtype in dtypes:
                lines.append(emit(parity(shape, dtype, device)))
                us = {}
                for impl, fn in IMPLS.items():
                    us[impl] = per_call_us(fn, shape, dtype, device)
                    lines.append(emit({"impl": impl, "shape": list(shape),
                                       "dtype": dtype_name(dtype),
                                       "per_call_us": us[impl]}))
                lines.append(emit({
                    "shape": list(shape), "dtype": dtype_name(dtype),
                    "flash_speedup": us["einsum"] / us["flash"],
                    "flash_vs_sdpa": us["sdpa"] / us["flash"]}))
    return lines


def main(argv=None) -> int:
    strict_f32()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: the plain version on the host")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_attention: torch.cuda.is_available() is false; pass "
              "--device cpu to run on the host", file=sys.stderr)
        return 2
    backend = (torch.cuda.get_device_name(0) if args.device == "cuda"
               else "cpu")
    emit({"backend": backend})
    lines = run(args.device)
    return 0 if all(x["ok"] for x in lines if "ok" in x) else 1


if __name__ == "__main__":
    sys.exit(main())
