"""Persistent serving loop (``serve`` of ``sd_video_gen_tpu/predict/serve.py``).

Warms up on one batch of the serving shape, prints ``SERVE_READY {json}``,
then answers length-prefixed requests on a Unix socket until ``shutdown``.
The warm-up is where a compiled predictor and decoder (``utils/jit.py``)
capture the serving shape's programs, so the compile is paid before
``SERVE_READY``, as the JAX server pays its trace and compile there:

  {"op": "ping"}      -> {"ok": true, "served": n}
  {"op": "shutdown"}  -> {"ok": true, "served": n}, the loop returns
  {"op": "predict", "shape": [B, T, H, W, 3], "labels": [..]?}
      + raw uint8 frames
      -> {"shape": [B, T_out, H, W, 3], "is_pred": [...], "latency_s": ..}
         + raw uint8 images (context minus its last frame, then predictions)

Ragged batches are padded to ``batch_clips`` and sliced on reply. Framing,
one request per connection: 8-byte big-endian header length, JSON header,
raw payload (the frames or images, ``prod(shape)`` bytes). It is the JAX
package's protocol byte for byte, so one client speaks to both servers; the
client helpers (``request``, ``ping``, ``shutdown``, ``wait_ready``) are
here too, so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import traceback

import numpy as np
import torch

_LEN = struct.Struct(">Q")


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b""):
    raw = json.dumps(header).encode()
    sock.sendall(_LEN.pack(len(raw)) + raw + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    (hlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    header = json.loads(_recv_exact(sock, hlen))
    n = int(np.prod(header["shape"])) if "shape" in header else 0
    return header, _recv_exact(sock, n) if n else b""


def _call(sock_path: str, header: dict, payload: bytes = b"",
          timeout_s: float = 10.0) -> tuple[dict, bytes]:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        s.settimeout(timeout_s)
        _send_msg(s, header, payload)
        return _recv_msg(s)


def ping(sock_path: str, timeout_s: float = 10.0) -> dict:
    return _call(sock_path, {"op": "ping"}, timeout_s=timeout_s)[0]


def shutdown(sock_path: str, timeout_s: float = 10.0) -> dict:
    return _call(sock_path, {"op": "shutdown"}, timeout_s=timeout_s)[0]


def request(sock_path: str, frames: np.ndarray,
            labels: list[int] | None = None,
            timeout_s: float = 600.0) -> tuple[np.ndarray, list[bool], dict]:
    """One round trip: uint8 frames (B, T, H, W, 3), and class ids for a
    text-mode server, -> ``(images (B, T_out, H, W, 3) uint8, is_pred flags,
    header)``."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 5 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (B,T,H,W,3) uint8, got "
                         f"{frames.shape}")
    header = {"op": "predict", "shape": list(frames.shape)}
    if labels is not None:
        header["labels"] = [int(x) for x in labels]
    resp, payload = _call(sock_path, header, frames.tobytes(), timeout_s)
    if "error" in resp:
        raise RuntimeError(f"server error: {resp['error']}")
    imgs = np.frombuffer(payload, np.uint8).reshape(resp["shape"])
    return imgs, resp["is_pred"], resp


def wait_ready(sock_path: str, deadline_s: float = 900.0,
               poll_s: float = 1.0) -> float:
    """Block until the server answers ping; returns the wait in seconds."""
    t0 = time.perf_counter()
    while True:
        try:
            ping(sock_path)
            return time.perf_counter() - t0
        except OSError:  # ConnectionError is one
            if time.perf_counter() - t0 > deadline_s:
                raise TimeoutError(
                    f"server at {sock_path} not ready in {deadline_s}s")
            time.sleep(poll_s)


def serve(sock_path: str, predict, decode, *, batch_clips: int,
          frames_per_clip: int, frame_size: int, embedder=None,
          warmup: bool = True) -> None:
    """Run the serving loop (blocks until a shutdown request).

    ``predict(frames_u8 (B, T, H, W, 3), text_embeds) -> (context (B, T, L),
    preds (B, P, L))`` and ``decode(latents (N, L)) -> (N, H, W, 3) uint8``
    are the built entry points (``make_predict_fn``, ``make_decode_fn`` or a
    codec's ``decode_latents``). ``embedder`` (text mode) maps a request's
    ``labels`` to the text embeddings; a request without labels gets class
    0. ``warmup`` runs one batch of the serving shape before the socket
    opens (compiling it); a ragged batch is padded to that shape, so every
    request replays the warm-up's programs.
    """
    shape = (batch_clips, frames_per_clip, frame_size, frame_size, 3)

    @torch.inference_mode()
    def run_batch(frames_np: np.ndarray, labels):
        n_items = frames_np.shape[0]
        if n_items > batch_clips:
            raise ValueError(f"batch of {n_items} exceeds the compiled "
                             f"serving batch {batch_clips}")
        if n_items < batch_clips:  # pad: one serving shape throughout
            pad = np.repeat(frames_np[-1:], batch_clips - n_items, axis=0)
            frames_np = np.concatenate([frames_np, pad], axis=0)
        text_embeds = None
        if embedder is not None:
            lab = list(labels or [0] * n_items)
            lab += [lab[-1]] * (batch_clips - len(lab))
            text_embeds = embedder(lab)
        context, preds = predict(frames_np, text_embeds)
        seq = torch.cat([context[:, :-1], preds], dim=1)
        T_out = seq.shape[1]
        imgs = decode(seq.reshape(-1, seq.shape[-1])).cpu().numpy()
        imgs = imgs.reshape(batch_clips, T_out, *imgs.shape[1:])[:n_items]
        is_pred = ([False] * (context.shape[1] - 1)
                   + [True] * preds.shape[1])
        return np.ascontiguousarray(imgs, dtype=np.uint8), is_pred

    t0 = time.perf_counter()
    if warmup:
        run_batch(np.zeros(shape, np.uint8), None)
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
                        imgs, is_pred = run_batch(frames,
                                                  header.get("labels"))
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
