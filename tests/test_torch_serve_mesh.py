"""``predict.main --serve SOCK --mesh ... --multihost`` of the port on the
CPU: servers of two gloo processes (``tests/torch_serve_mesh_case.py``) at
tiny widths, each driven by a client here.

  (a) a ``data=2`` and a ``data=1,model=2 --denoise`` server answer a full,
      a ragged and an oversize request (an error reply; the server lives
      on), a text-mode ``data=2`` server a request with labels, and
      ``shutdown`` ends both ranks with exit code 0, each having found no
      program of ``predict.main`` alive once it returned;
  (b) every reply equals, bit for bit, the frames of the port's batch CLI
      under the same mesh on the same clips (a ragged request's padding
      included), and is within ``test_predict_mesh_matches_one_process``'s
      tolerance of the batch CLI in one process;
  (c) the ``data=2`` server's replies agree with the JAX package's ``predict
      --serve --mesh data=2`` on the same checkpoint and clips, within
      ``test_torch_predict_cli.py``'s tolerance (the pixel codec: the
      refiner's noise cannot be matched across frameworks);
  (d) a rank that raises inside ``predict`` ends both ranks with a non-zero
      exit code within the wait.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from chip_smoke import write_test_clips
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.predict import predict as P
from sd_video_gen_tpu_torch.predict import serve as S
from tests import torch_serve_mesh_case as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, SIZE = 5, 32
# each case's requests, as clip indices: the ragged one is padded with its
# last clip, as the server pads it
REQUESTS = {"data2": [range(0, 4), range(4, 6), range(6, 10)],
            "model2": [range(0, 2), range(2, 3)],
            "text": [range(0, 2), range(0, 2)],
            "fail": [range(0, 2)]}
LABELS = {"data2": [None, None, [1, 2, 3, 4]], "text": [[3, 7], None]}
WAIT_S = 120


def _padded(case) -> list:
    batch = C.CASES[case][1]
    return [list(r) + [r[-1]] * (batch - len(r)) for r in REQUESTS[case]]


def _write(root, clips) -> None:
    with open(os.path.join(root, C.CONFIG + ".yml"), "w") as f:
        f.write(C.YAML)
    for name, mode, seed in (("ref.pt", "ar", 4), ("text.pt", "text", 5)):
        mc = FrameTransformerConfig(latent_dim=64, dim_model=32, num_heads=4,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    frames_to_predict=2, mode=mode)
        m = build(FrameTransformer, mc, "cpu", seed=seed)
        # the reference's layout: the positional buffer it saves as well
        torch.save(dict(m.state_dict(), **{
            "positional_encoder.pos_encoding": torch.zeros(64, 1, 32)}),
            os.path.join(root, name))
    for case in C.CASES:
        write_test_clips(
            C.clips_path(root, case),
            clips[[i for r in _padded(case) for i in r]])


def _rgb(clips):
    return np.repeat(clips[..., None], 3, axis=-1)


def _one_process(root, case) -> list:
    """The batch CLI in this process: its decoded frames, a batch each."""
    frames: list = []
    with C.tiny_sd(), C.decoded(frames), \
            contextlib.redirect_stdout(io.StringIO()):
        P.main(C.argv(root, case, "--max_clips", "1000"))
    return [f.numpy() for f in frames]


def _jax_replies(root, requests) -> list:
    """The JAX package's server under ``--mesh data=2`` on two of the
    suite's virtual CPU devices (the mesh must hold every device it is
    given), in a thread here: its replies to ``requests``."""
    import jax
    from sd_video_gen_tpu.predict import predict as JP
    sock = os.path.join(root, "jax.sock")
    devices = jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a, **k: devices[:2])
    argv = C.argv(root, "data2", "--serve", sock, "--mesh", "data=2")
    i = argv.index("--device")           # the JAX CLI has no --device
    th = threading.Thread(target=JP.main, args=(argv[:i] + argv[i + 2:],),
                          daemon=True)
    try:
        th.start()
        S.wait_ready(sock, deadline_s=WAIT_S)
        out = [S.request(sock, f, labels=lab)[0] for f, lab in requests]
        S.shutdown(sock)
        th.join(timeout=WAIT_S)
    finally:
        mp.undo()
    assert not th.is_alive()
    return out


def _drive(root, case, clips) -> dict:
    """The client of ``case``'s server: its replies, an oversize request's
    error, then ``shutdown``."""
    sock = C.sock_path(root, case)
    S.wait_ready(sock, deadline_s=WAIT_S)
    out = {"replies": [], "errors": []}
    for r, lab in zip(REQUESTS[case], LABELS.get(case, [None] * 3)):
        imgs, is_pred, _ = S.request(sock, _rgb(clips[list(r)]), labels=lab,
                                     timeout_s=WAIT_S)
        out["replies"].append(imgs)
        out["is_pred"] = is_pred
    batch = C.CASES[case][1]
    with pytest.raises(RuntimeError, match="exceeds the compiled") as e:
        S.request(sock, _rgb(clips[:batch + 1]))
    out["errors"].append(str(e.value))
    out["ping"] = S.ping(sock)
    out["shutdown"] = S.shutdown(sock)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_mesh"))
    out = str(tmp_path_factory.mktemp("serve_mesh_out"))
    clips = np.random.default_rng(3).integers(0, 256, (10, T, SIZE, SIZE),
                                              dtype=np.uint8)
    _write(root, clips)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for case in C.CASES:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs[case] = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_serve_mesh_case", str(r),
             "2", str(port), root, out, case], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    res, logs = {"clips": clips}, {}
    try:
        one = {case: _one_process(root, case) for case in ("data2", "model2")}
        for case in ("data2", "model2", "text"):
            res[case] = _drive(root, case, clips)
            logs[case] = [p.communicate(timeout=WAIT_S)[0]
                          for p in procs[case]]
        res["jax"] = _jax_replies(root, [
            (_rgb(clips[list(r)]), lab)
            for r, lab in zip(REQUESTS["data2"], LABELS["data2"])])
        # (d): the first request after the warm-up fails on rank 1
        S.wait_ready(C.sock_path(root, "fail"), deadline_s=WAIT_S)
        with pytest.raises((OSError, RuntimeError)):
            S.request(C.sock_path(root, "fail"), _rgb(clips[:2]),
                      timeout_s=WAIT_S)
        logs["fail"] = [p.communicate(timeout=WAIT_S)[0]
                        for p in procs["fail"]]
    finally:
        torch.set_num_threads(n)
        for ps in procs.values():
            for p in ps:
                p.kill()
    res["rcs"] = {case: [p.returncode for p in ps]
                  for case, ps in procs.items()}
    res["logs"] = logs
    for case in ("data2", "model2", "text"):
        for p, log in zip(procs[case], logs[case]):
            assert p.returncode == 0, log[-4000:]
    res["one"] = one
    res["cli"] = {case: [torch.load(os.path.join(
        out, f"{case}_rank{r}.pt"), weights_only=False)["frames"]
        for r in range(2)] for case in ("data2", "model2")}
    return res


def _cli_clips(case, ranks_frames) -> list:
    """The batch CLI's decoded frames under the mesh, as (clips, T_out, H,
    W, 3) a batch: the data ranks' rows in order (model rank 0's)."""
    mesh = C.CASES[case][0]
    per_rank = ranks_frames if mesh.startswith("data=2") else ranks_frames[:1]
    batches = []
    for parts in zip(*per_rank):
        batches.append(np.concatenate(parts))
    return batches


@pytest.mark.parametrize("case", ["data2", "model2", "text"])
def test_servers_answer_and_shut_down(served, case):
    """(a)"""
    got = served[case]
    assert served["rcs"][case] == [0, 0]
    assert got["shutdown"]["ok"] and got["ping"]["ok"]
    assert got["shutdown"]["served"] == sum(len(r) for r in REQUESTS[case])
    assert got["errors"] and "exceeds the compiled" in got["errors"][0]
    pred = int(C.CASES[case][2][C.CASES[case][2].index("--pred_frames")
                                + 1])
    for r, imgs in zip(REQUESTS[case], got["replies"]):
        assert imgs.shape == (len(r), T - 1 + pred, SIZE, SIZE, 3)
    assert got["is_pred"] == [False] * (T - 1) + [True] * pred
    if case == "text":
        # the labels reached the embedder on both ranks: class 3 and 7
        # against class 0 on the same clips
        a, b = got["replies"]
        assert not np.array_equal(a[:, T - 1:], b[:, T - 1:])
        assert np.array_equal(a[:, :T - 1], b[:, :T - 1])


@pytest.mark.parametrize("case", ["data2", "model2"])
def test_replies_are_the_batch_clis_frames(served, case):
    """(b) bit for bit under the same mesh; one process within one uint8
    level on at most 1% of the pixels."""
    cli = _cli_clips(case, served["cli"][case])
    one = served["one"][case]
    replies = served[case]["replies"]
    assert len(cli) == len(one) == len(replies)
    for reply, mesh, single in zip(replies, cli, one):
        mesh = mesh.reshape(-1, *reply.shape[1:])
        single = single.reshape(mesh.shape)
        assert np.array_equal(reply, mesh[:len(reply)])
        diff = np.abs(mesh.astype(int) - single.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_data2_server_matches_the_jax_server(served):
    """(c)"""
    for port, jax_ in zip(served["data2"]["replies"], served["jax"]):
        assert port.shape == jax_.shape
        diff = np.abs(port.astype(int) - jax_.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_a_failing_rank_ends_the_group(served):
    """(d) both ranks non-zero, rank 1 by its own failure, rank 0 by the
    group's end, not by the client's timeout."""
    assert all(rc not in (0, None) for rc in served["rcs"]["fail"])
    log0, log1 = served["logs"]["fail"]
    assert "injected failure inside predict" in log1
    assert "ending this process" in log0
