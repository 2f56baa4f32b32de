"""Closed-loop serving through the port's server: ``predict/serve.py``
runs in a thread of this process with the compiled predict and decode
programs at ``clips_per_request`` clips, on a Unix socket under
``TMPDIR``; one client sends a request, waits for the whole reply, and
sends the next.

Set-up builds the models from the seed and starts the server, which
compiles the serving shape before it answers; the client then sends one
request that replays the programs, and requests back to back for the
traffic's ``warm_s`` seconds: a freshly started server on the card answers
its first seconds of requests about 15 ms slower (331-332 ms against
316-317 ms at B=1), for 2 to 18 s, and a long-running server's users do
not see that. In the window each request's latency
is the client's time from sending to holding the whole reply; a request
that fails counts as missing the limit (infinite latency).
``latency_p90_ms`` is the 90th percentile over every request of the
window. The server's reply carries its own time (``latency_s``); the
difference is the serving loop's cost. The comparison takes the frames
of ``check_requests`` replies, drawn from the seed, and the latents the
same requests produced inside the server (``_serving.compare``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

import torch

from benchmark import harness
from benchmark import traffic as TR
from benchmark.drivers import _serving as S
from benchmark.drivers.predict_closed import check, free, repeat, traced


def socket_path() -> str:
    path = os.path.join(tempfile.gettempdir(),
                        f"sdvg-bench-{os.getpid()}.sock")
    if len(path) > 100:
        raise RuntimeError(f"socket path {path!r} is too long for AF_UNIX")
    return path


def run(run) -> None:
    from sd_video_gen_tpu_torch.predict import serve as server
    tr = run.traffic
    B, pred = tr["clips_per_request"], tr["pred_frames"]
    served = S.build_port(run.config, run.seed, run.device, pred)
    produced = []            # (context, preds) of every predict call

    def predict(frames, text_embeds=None):
        out = served.predict(frames, text_embeds)
        produced.append(out)
        return out

    sock = socket_path()
    thread = threading.Thread(
        target=server.serve, args=(sock, predict, served.decode),
        kwargs=dict(batch_clips=B, frames_per_clip=tr["context_frames"],
                    frame_size=tr["frame_size"]), daemon=True)
    thread.start()
    try:
        server.wait_ready(sock, deadline_s=600.0, poll_s=0.05)
        server.request(sock, TR.clips(tr, run.seed, -1))
        t_w, k = time.perf_counter(), 2
        while time.perf_counter() - t_w < tr.get("warm_s", 0):
            server.request(sock, TR.clips(tr, run.seed, -k))
            k += 1
        first = len(produced)        # the warm-up's and the warm requests'
        records, latencies, overhead, failed = [], [], [], 0

        def serve_one():
            nonlocal failed
            frames = TR.clips(tr, run.seed, len(latencies))
            t1 = time.perf_counter()
            try:
                imgs, _, header = server.request(sock, frames)
            except Exception as e:
                print(f"request failed: {type(e).__name__}: {e}", flush=True)
                failed += 1
                latencies.append(float("inf"))
                return
            latencies.append(time.perf_counter() - t1)
            records.append((frames, imgs))
            overhead.append((latencies[-1] - header["latency_s"]) * 1e3)

        t0 = time.perf_counter()
        run.setup_s = t0 - run.t_start
        tracer = (traced(tr["trace_units"],
                         repeat(serve_one, tr["trace_units"]))
                  if run.traced else None)
        n_traced, n_over = len(latencies), len(overhead)
        while time.perf_counter() - t0 < run.seconds:
            serve_one()
    finally:
        if thread.is_alive():
            server.shutdown(sock)
        thread.join()
    if tracer is not None:
        run.trace = tracer.trace()
    run.attempted, run.failed = len(latencies), failed
    run.e2e["latency_p90_ms"] = harness.percentile(latencies, 90) * 1e3
    run.counters["serve_overhead_ms"] = overhead[n_over:]
    ms = sorted(x * 1e3 for x in latencies[n_traced:])
    print(f"readings {len(ms)} requests after the traced ones " + json.dumps(
        {"latency_ms": {f"p{q}": ms[min(len(ms) - 1, len(ms) * q // 100)]
                        for q in (0, 10, 25, 50, 75, 90, 100)} if ms
         else None}), file=sys.stderr)
    if torch.cuda.is_available():
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    latents = produced[first:]
    del served, produced
    free()
    run.check("failed_requests", failed, 0)
    if failed or len(latents) != len(records):
        run.check("replies_matched", 1, 0)
        return
    if run.traced:
        run.work = S.request_work(run.config, B, pred)
    check(run, [(frames, *lat, imgs) for (frames, imgs), lat in
                zip(records, latents)], B)
