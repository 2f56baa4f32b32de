"""Persistent serving loop (``serve`` of ``sd_video_gen_tpu/predict/serve.py``).

Warms up on one batch of the serving shape, prints ``SERVE_READY {json}``,
then answers length-prefixed requests on a Unix socket until ``shutdown``:

  {"op": "ping"}      -> {"ok": true, "served": n}
  {"op": "shutdown"}  -> {"ok": true, "served": n}, the loop returns
  {"op": "predict", "shape": [B, T, H, W, 3]} + raw uint8 frames
      -> {"shape": [B, T_out, H, W, 3], "is_pred": [...], "latency_s": ..}
         + raw uint8 images (context minus its last frame, then predictions)

Ragged batches are padded to ``batch_clips`` and sliced on reply. The wire
framing and the client helpers (``request``, ``ping``, ``shutdown``,
``wait_ready``) are the JAX package's own: that module is numpy + socket at
import time, so both servers speak exactly one protocol.
"""

from __future__ import annotations

import json
import os
import socket
import time
import traceback

import numpy as np
import torch

from sd_video_gen_tpu.predict.serve import (_recv_msg, _send_msg, ping,  # noqa: F401
                                            request, shutdown, wait_ready)


def serve(sock_path: str, predict, decode, *, batch_clips: int,
          frames_per_clip: int, frame_size: int) -> None:
    """Run the serving loop (blocks until a shutdown request).

    ``predict(frames_u8 (B, T, H, W, 3)) -> (context (B, T, L), preds
    (B, P, L))`` and ``decode(latents (N, L)) -> (N, H, W, 3) uint8`` are the
    built entry points (``make_predict_fn``, ``VAECodec.decode_latents``).
    """
    shape = (batch_clips, frames_per_clip, frame_size, frame_size, 3)

    @torch.inference_mode()
    def run_batch(frames_np: np.ndarray):
        n_items = frames_np.shape[0]
        if n_items > batch_clips:
            raise ValueError(f"batch of {n_items} exceeds the compiled "
                             f"serving batch {batch_clips}")
        if n_items < batch_clips:  # pad: one serving shape throughout
            pad = np.repeat(frames_np[-1:], batch_clips - n_items, axis=0)
            frames_np = np.concatenate([frames_np, pad], axis=0)
        context, preds = predict(frames_np)
        seq = torch.cat([context[:, :-1], preds], dim=1)
        T_out = seq.shape[1]
        imgs = decode(seq.reshape(-1, seq.shape[-1])).cpu().numpy()
        imgs = imgs.reshape(batch_clips, T_out, *imgs.shape[1:])[:n_items]
        is_pred = ([False] * (context.shape[1] - 1)
                   + [True] * preds.shape[1])
        return np.ascontiguousarray(imgs, dtype=np.uint8), is_pred

    t0 = time.perf_counter()
    run_batch(np.zeros(shape, np.uint8))
    ready_s = time.perf_counter() - t0

    if os.path.exists(sock_path):
        os.unlink(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)
    print("SERVE_READY " + json.dumps(
        {"ready_s": round(ready_s, 3), "batch_clips": batch_clips,
         "frames_per_clip": frames_per_clip, "frame_size": frame_size,
         "sock": sock_path}), flush=True)

    n_served = 0
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    header, payload = _recv_msg(conn)
                except (ConnectionError, json.JSONDecodeError) as e:
                    print(f"serve: bad request dropped ({e})", flush=True)
                    continue
                op = header.get("op")
                if op in ("ping", "shutdown"):
                    _send_msg(conn, {"ok": True, "served": n_served})
                    if op == "shutdown":
                        return
                elif op == "predict":
                    t1 = time.perf_counter()
                    try:
                        frames = np.frombuffer(payload, np.uint8).reshape(
                            header["shape"])
                        imgs, is_pred = run_batch(frames)
                    except Exception as e:  # report, keep serving
                        traceback.print_exc()
                        _send_msg(conn, {"error": str(e)})
                        continue
                    n_served += frames.shape[0]
                    _send_msg(conn, {
                        "shape": list(imgs.shape), "is_pred": is_pred,
                        "latency_s": round(time.perf_counter() - t1, 4)},
                        imgs.tobytes())
                else:
                    _send_msg(conn, {"error": f"unknown op {op!r}"})
    finally:
        srv.close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)
