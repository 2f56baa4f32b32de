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

Across a process group (``predict --serve SOCK --mesh ...``, ``layout``),
every rank warms up on the serving shape, compiling the same programs in
the same order, and rank 0 prints ``SERVE_READY`` once all have. Rank 0
alone binds the socket and answers. Each predict request it accepts
(what it can refuse, it answers with an error before anyone else sees it)
goes to every rank by broadcast, outside the programs: a header of ints
(the op, the real row count, the labels) and the padded uint8 frames of
the serving shape. Each rank predicts and decodes its rows
(``Layout.rows``; the refiner's noise window is set to them), model rank 0
of each data group sends its images to rank 0, and rank 0 replies. While
no request comes, rank 0 broadcasts an idle header every ``IDLE_S``, so a
rank that waits ``WAIT_S`` for a header has lost rank 0 and raises.
``shutdown`` is broadcast too, and every rank returns. Unlike the JAX
server, which reports a failed request and serves on, a failure on any rank
ends every rank with exit code 1 (``multihost.end_group_on_failure``):
after a failed collective the communicators cannot be trusted.
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

from sd_video_gen_tpu_torch.parallel import multihost

_LEN = struct.Struct(">Q")
# across a group: rank 0's idle header every IDLE_S seconds; a rank gives
# up on rank 0 after WAIT_S without a header; rank 0 gives a client
# CLIENT_S to send its request
IDLE_S, WAIT_S, CLIENT_S = 1.0, 120.0, 30.0
OP_IDLE, OP_PREDICT, OP_SHUTDOWN = 0, 1, 2


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
          warmup: bool = True, layout=None, window=None) -> None:
    """Run the serving loop (blocks until a shutdown request).

    ``predict(frames_u8 (B, T, H, W, 3), text_embeds) -> (context (B, T, L),
    preds (B, P, L))`` and ``decode(latents (N, L)) -> (N, H, W, 3) uint8``
    are the built entry points (``make_predict_fn``, ``make_decode_fn`` or a
    codec's ``decode_latents``). ``embedder`` (text mode) maps a request's
    ``labels`` to the text embeddings; a request without labels gets class
    0. ``warmup`` runs one batch of the serving shape before the socket
    opens (compiling it); a ragged batch is padded to that shape, so every
    request replays the warm-up's programs.

    ``layout`` (``parallel/mesh.Layout``) serves across the process group,
    where there is one (module docstring): every rank calls ``serve`` and
    computes its rows of each batch, and ``window`` (the predictor's
    ``BatchWindow``) is set to them.
    """
    shape = (batch_clips, frames_per_clip, frame_size, frame_size, 3)
    group = layout is not None and torch.distributed.is_initialized()
    lead = multihost.is_coordinator()
    lo, hi = layout.rows(batch_clips) if group else (0, batch_clips)
    if window is not None and group:
        window.set(lo, hi, batch_clips)

    def pad(frames_np: np.ndarray, labels):
        """The request at the serving shape and its labels (one a row, or
        None), or a ValueError to answer with."""
        n_items = frames_np.shape[0]
        if n_items > batch_clips:
            raise ValueError(f"batch of {n_items} exceeds the compiled "
                             f"serving batch {batch_clips}")
        if group and (tuple(frames_np.shape[1:]) != shape[1:] or (
                embedder is not None and labels is not None
                and len(labels) != n_items)):
            # the broadcast carries the serving shape and a label a row
            raise ValueError(f"clips {list(frames_np.shape)} with "
                             f"{len(labels or [])} labels: the group serves "
                             f"clips of {list(shape[1:])} and a label for "
                             f"each or none")
        if n_items < batch_clips:  # pad: one serving shape throughout
            pad_ = np.repeat(frames_np[-1:], batch_clips - n_items, axis=0)
            frames_np = np.concatenate([frames_np, pad_], axis=0)
        if embedder is None:
            return frames_np, None
        lab = [int(x) for x in (labels or [0] * n_items)]
        return frames_np, lab + [lab[-1]] * (batch_clips - len(lab))

    @torch.inference_mode()
    def rows(frames, labels):
        """This rank's rows of a padded batch -> (images (rows, T_out, H,
        W, 3) uint8 or None where it holds no row, is_pred)."""
        if hi == lo:
            return None, None
        text_embeds = None if labels is None else embedder(labels[lo:hi])
        context, preds = predict(frames[lo:hi], text_embeds)
        seq = torch.cat([context[:, :-1], preds], dim=1)
        imgs = decode(seq.reshape(-1, seq.shape[-1])).cpu().numpy()
        is_pred = ([False] * (context.shape[1] - 1)
                   + [True] * preds.shape[1])
        return imgs.reshape(hi - lo, seq.shape[1], *imgs.shape[1:]), is_pred

    def run_batch(frames, labels, n_items):
        """Every rank: its rows; rank 0 -> the reply's (images of the first
        ``n_items`` clips, is_pred), the others -> None."""
        imgs, is_pred = rows(frames, labels)
        if group:
            # every data rank's rows, in order, from model rank 0 of each
            parts = multihost.gather_to_coordinator(
                (imgs, is_pred) if layout.model_rank == 0 else None)
            if not lead:
                return None
            got = [parts[d * layout.model] for d in range(layout.data)]
            got = [p for p in got if p is not None and p[0] is not None]
            imgs = np.concatenate([p[0] for p in got])
            is_pred = got[0][1]
        return np.ascontiguousarray(imgs[:n_items], dtype=np.uint8), is_pred

    def warm():
        t0 = time.perf_counter()
        if warmup:
            run_batch(np.zeros(shape, np.uint8),
                      None if embedder is None else [0] * batch_clips,
                      batch_clips)
        ready_s = time.perf_counter() - t0
        if group:
            multihost.barrier()     # every rank has compiled
        return ready_s

    if not group:
        _answer(sock_path, warm(), pad, run_batch, shape)
        return
    with multihost.end_group_on_failure():
        ready_s = warm()
        if not lead:
            _follow(run_batch, shape, batch_clips)
            return

        def run_all(frames_np, labels, n_items):
            head = [OP_PREDICT, n_items, labels is not None, *(labels or [])]
            multihost.broadcast_ints(head, 3 + batch_clips, WAIT_S)
            frames = multihost.broadcast(torch.tensor(frames_np), WAIT_S)
            return run_batch(frames, labels, n_items)

        def idle(op=OP_IDLE):
            multihost.broadcast_ints([op], 3 + batch_clips, WAIT_S)
        _answer(sock_path, ready_s, pad, run_all, shape, idle)


def _follow(run_batch, shape, batch_clips) -> None:
    """A rank other than 0: take each broadcast request and compute its
    rows, until ``shutdown``."""
    buf = torch.zeros(shape, dtype=torch.uint8)
    while True:
        op, n_items, has_labels, *labels = multihost.broadcast_ints(
            None, 3 + batch_clips, WAIT_S)
        if op == OP_SHUTDOWN:
            return
        if op == OP_PREDICT:
            frames = multihost.broadcast(buf, WAIT_S)
            run_batch(frames, labels if has_labels else None, n_items)


def _answer(sock_path, ready_s, pad, run_batch, shape, idle=None) -> None:
    """Rank 0 (or the one process): bind ``sock_path``, print
    ``SERVE_READY`` and answer until ``shutdown``. ``idle`` (across a group)
    broadcasts an op to the other ranks: the idle header while no request
    comes, and ``shutdown``."""
    batch_clips, frames_per_clip, frame_size = shape[:3]
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)
    if idle is not None:
        srv.settimeout(IDLE_S)
    print("SERVE_READY " + json.dumps(
        {"ready_s": round(ready_s, 3), "batch_clips": batch_clips,
         "frames_per_clip": frames_per_clip, "frame_size": frame_size,
         "sock": sock_path}), flush=True)

    n_served = 0
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                idle()
                continue
            with conn:
                conn.settimeout(None if idle is None else CLIENT_S)
                try:
                    header, payload = _recv_msg(conn)
                except (OSError, json.JSONDecodeError) as e:
                    print(f"serve: bad request dropped ({e})", flush=True)
                    continue
                op = header.get("op")
                if op in ("ping", "shutdown"):
                    _send_msg(conn, {"ok": True, "served": n_served})
                    if op == "shutdown":
                        if idle is not None:
                            idle(OP_SHUTDOWN)
                        return
                elif op == "predict":
                    t1 = time.perf_counter()
                    try:
                        frames = np.frombuffer(payload, np.uint8).reshape(
                            header["shape"])
                        frames_p, labels = pad(frames, header.get("labels"))
                    except Exception as e:  # refused: nothing ran
                        _send_msg(conn, {"error": str(e)})
                        continue
                    try:
                        imgs, is_pred = run_batch(frames_p, labels,
                                                  frames.shape[0])
                    except Exception as e:  # report, keep serving
                        if idle is not None:
                            raise           # the group ends (serve)
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
