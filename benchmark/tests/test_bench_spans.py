"""The stage and span readers (``metrics/_spans.py``) on synthetic traces:
the device ms inside each stage, idle gaps left out; the host ms of a span;
the device's idle ms inside a span; and None where a mark or a span is
missing, or where the program has none at all."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.trace import Trace

READ = {m.name: m.read for m in harness.per_layer().values()}


def _run(cell: str, trace: Trace, **traffic) -> harness.Run:
    r = harness.load_run(cell, 1, 1.0, True, 0.0, device="cpu")
    r.traffic = dict(r.traffic, **traffic)
    r.trace = trace
    return r


def _ops(plan, t0=0.0):
    """[(name, start, end)] of ``plan``: (name, length) laid out back to
    back from ``t0``, a None name being an idle gap of that length."""
    out, t = [], t0
    for name, length in plan:
        if name is not None:
            out.append((name, t, t + length))
        t += length
    return out, t


def _request(t0):
    """One request of one predicted frame: predict_impl's marks and work,
    then decode_impl's (microseconds)."""
    return _ops([
        ("sdvg_mark_vae", 1), ("conv_encode", 99),              # 100 vae
        ("sdvg_mark_rollout", 1), ("gemm", 19), (None, 50),     # 20 rollout
        ("sdvg_mark_vae", 1), ("conv_dec_enc", 199),            # 200 vae
        ("sdvg_mark_unet", 1), ("gemm_unet", 999),              # 1000 unet
        ("sdvg_mark_vae", 1), ("conv_back", 299),               # 300 vae
        ("sdvg_mark_end", 1), ("copy_out", 9), (None, 30),      # 10 end
        ("sdvg_mark_vae", 1), ("conv_decode", 399),             # 400 vae
        ("sdvg_mark_end", 1), ("memcpy_dtoh", 4), (None, 10),   # 5 end
    ], t0)


def _serving_trace(units=2, drop=None):
    ops, t = [], 5.0
    for _ in range(units):
        more, t = _request(t)
        ops += more
    if drop is not None:
        ops = [o for i, o in enumerate(ops) if i != drop]
    return Trace(ops, [], (0.0, t + 5), units)


def test_the_stage_readers_give_each_models_device_ms_a_request():
    r = _run("sd14_refine_b8", _serving_trace(), pred_frames=1)
    assert READ["stage_unet_ms.frames"](r) == pytest.approx(1000 / 1e3)
    assert READ["stage_vae_ms.frames"](r) == pytest.approx(1000 / 1e3)
    assert READ["stage_rollout_ms.frames"](r) == pytest.approx(20 / 1e3)


@pytest.mark.parametrize("drop", [0, 2, 6, 10, 14])
def test_the_stage_readers_read_nothing_where_a_mark_is_missing(drop):
    r = _run("sd14_refine_b8", _serving_trace(drop=drop), pred_frames=1)
    for name in ("stage_unet_ms.frames", "stage_vae_ms.frames", "stage_rollout_ms.frames"):
        assert READ[name](r) is None, name


def test_the_readers_read_nothing_in_a_program_without_marks_or_spans():
    ops = [(n, s, e) for n, s, e in _serving_trace().device_ops
           if not n.startswith("sdvg_mark_")]
    bare = Trace(ops, [("cudaGraphLaunch", 10.0, 20.0)], (0.0, 5000.0), 2)
    for cell, names in (("sd14_refine_b8", ("stage_unet_ms.frames",
                                            "stage_vae_ms.frames",
                                            "stage_rollout_ms.frames")),
                        ("sd14_refine_b1_serve", ("span_request_idle_ms.latency",)),
                        ("train_b6", ("stage_forward_ms.train", "stage_backward_ms.train",
                                      "span_feed_copy_ms.train", "span_launch_ms.train"))):
        r = _run(cell, bare, pred_frames=1)
        for name in names:
            assert READ[name](r) is None, name
        r.trace = None
        for name in names:
            assert READ[name](r) is None, name


def _steps(units, chips=1):
    plan = []
    for i in range(units):
        plan += [("sdvg_mark_forward", 1), ("gemm_fwd", 99 + i),
                 (None, 20), ("sdvg_mark_backward", 1), ("gemm_bwd", 199)]
        if chips > 1:
            plan += [("sdvg_mark_exchange", 1), ("ncclAllReduce", 49)]
        plan += [("sdvg_mark_optimizer", 1),
                 ("multi_tensor_apply_kernel", 299),
                 ("sdvg_mark_end", 1), (None, 100)]
    ops, t = _ops(plan, 10.0)
    return ops, t


def test_the_step_readers_give_forward_and_backward_ms_a_step():
    ops, t = _steps(2)
    r = _run("train_b6", Trace(ops, [], (0.0, t), 2))
    assert READ["stage_forward_ms.train"](r) == pytest.approx(100.5 / 1e3)
    assert READ["stage_backward_ms.train"](r) == pytest.approx(200 / 1e3)
    four = _run("train_b6", Trace(ops, [], (0.0, t), 2))
    four.cell = dict(four.cell, chips=4)     # an exchange a step is implied
    assert READ["stage_forward_ms.train"](four) is None
    ops4, t4 = _steps(2, chips=4)
    four.trace = Trace(ops4, [], (0.0, t4), 2)
    assert READ["stage_backward_ms.train"](four) == pytest.approx(200 / 1e3)
    r.trace = Trace([o for o in ops if o[0] != "sdvg_mark_backward"], [],
                    (0.0, t), 2)
    assert READ["stage_backward_ms.train"](r) is None


def test_the_span_readers_give_the_median_ms_one_a_step():
    host, device = [], []
    for i, (wait, copy, launch) in enumerate(((400, 100, 2000),
                                              (300, 400, 2600),
                                              (900, 200, 2200))):
        t = 10_000.0 * i + 100
        feed = wait + copy
        host += [("train.step", t, t + 5000), ("train.feed", t, t + feed),
                 ("jit.step_impl", t + feed, t + feed + launch)]
        # the step before runs on while the feed waits; then its copy
        device += [("gemm_before", t - 50, t + wait),
                   ("Memcpy HtoD (Pageable -> Device)", t + wait,
                    t + feed - 10),
                   ("Memcpy HtoD (Pageable -> Device)", t + feed - 10,
                    t + feed),
                   ("gemm_step", t + feed + 100, t + feed + launch)]
    host.sort(key=lambda h: h[1])
    r = _run("train_b6", Trace(device, host, (0.0, 30_000.0), 3))
    assert READ["span_feed_copy_ms.train"](r) == pytest.approx(0.2)
    assert READ["span_launch_ms.train"](r) == pytest.approx(2.2)
    r.trace = Trace(device, host[:-1], (0.0, 30_000.0), 3)   # one span short
    assert READ["span_launch_ms.train"](r) is None
    assert READ["span_feed_copy_ms.train"](r) == pytest.approx(0.2)
    no_copy = [d for d in device if d[1] > 10_000.0 or "Memcpy" not in d[0]]
    r.trace = Trace(no_copy, host, (0.0, 30_000.0), 3)  # a feed copied nothing
    assert READ["span_feed_copy_ms.train"](r) is None


def test_request_idle_is_the_device_idle_inside_each_client_span():
    # request 1: 1000 us, busy 600 of it; request 2: 2000 us, busy 1900
    # (100 of its device work before the span starts is not counted)
    device = [("k", 100.0, 400.0), ("k", 500.0, 800.0),
              ("k", 1900.0, 2200.0), ("k", 2200.0, 3800.0),
              ("k", 3900.0, 4100.0)]
    host = [("serve.request", 0.0, 1000.0), ("serve.request", 2000.0, 4000.0)]
    r = _run("sd14_refine_b1_serve", Trace(device, host, (0.0, 5000.0), 2))
    assert READ["span_request_idle_ms.latency"](r) == pytest.approx(
        (400 + 100) / 2 / 1e3)
