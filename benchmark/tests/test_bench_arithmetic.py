"""The yardstick's arithmetic on known shapes: the kernels' operations and
bytes, the roofline and peak shares, the spreads and percentiles, and the
trace's reductions."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, roofline
from benchmark.drivers import _serving as S
from benchmark.drivers import train as T
from benchmark.metrics import _readers
from benchmark.trace import Trace, bucket_of


def test_k1_operations_and_bytes():
    ops, nbytes = roofline.k1_ops_bytes(64, 4096, 4096, 40, 2)
    assert ops == 4 * 64 * 4096 * 4096 * 40
    assert nbytes == 2 * 4 * 64 * 4096 * 40
    ops, nbytes = roofline.k1_ops_bytes(8, 64, 77, 160, 2)   # Tq != Tk
    assert ops == 4 * 8 * 64 * 77 * 160
    assert nbytes == 2 * (2 * 8 * 64 * 160 + 2 * 8 * 77 * 160)


def test_least_time_takes_the_larger_bound():
    ops, nbytes = roofline.k1_ops_bytes(64, 4096, 4096, 40, 2)
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        ops / roofline.BF16_FLOPS)
    b = roofline.k2_bytes((8, 128, 512, 512), 2)
    assert b == 2 * 2 * 8 * 128 * 512 * 512
    assert roofline.least_seconds(0.0, b) == pytest.approx(b / 3.35e12)
    assert roofline.share(1.0, 4.0) == 25.0
    assert roofline.share(0.0, 4.0) is None


def _trace(units=2):
    ops = [("flash_fwd_wgmma<...>", 0, 100), ("gn_nhwc_cluster<...>", 100,
                                              150),
           ("multi_tensor_apply_kernel", 200, 260),
           ("sm80_xmma_gemm_bf16", 250, 300), ("Memcpy HtoD", 400, 450)]
    host = [("bench.request", 0, 500), ("cudaStreamSynchronize", 300, 420)]
    return Trace(ops, host, (0, 1000), units)


def test_trace_busy_idle_buckets_and_gaps():
    t = _trace()
    assert t.busy_s() == pytest.approx(300e-6)   # 0-150, 200-300, 400-450
    assert t.idle_share() == pytest.approx(0.7)
    b = t.by_bucket()
    assert b["optimizer"] == pytest.approx(60e-6)
    assert b["matrix products"] == pytest.approx(50e-6)
    assert "convolutions" not in b
    gaps = t.idle_gaps(3)
    assert gaps[0] == ["no host operation", pytest.approx(550e-6)]
    assert gaps[1] == ["cudaStreamSynchronize", pytest.approx(100e-6)]
    assert gaps[2] == ["bench.request", pytest.approx(50e-6)]


def test_buckets_name_adam_and_cublas_right():
    assert bucket_of("multi_tensor_apply_kernel<TensorListMetadata<4>>") \
        == "optimizer"
    assert bucket_of("sm80_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") \
        == "matrix products"
    assert bucket_of("gemmSN_TN_kernel") == "matrix products"
    assert bucket_of("sm90_xmma_fprop_implicit_gemm_bf16") == "convolutions"
    assert bucket_of("cudnn::bn_fw_tr_1C11_kernel") == "convolutions"


class _Run:
    def __init__(self, trace, work, precision="bf16", chips=1):
        self.trace, self.work, self.chips = trace, work, chips
        self.config = {"precision": precision}
        self.counters = {}


def test_kernel_roofline_and_mfu_readers():
    work = roofline.Work(1e12, {("attention", 64, 4096, 4096, 40): 1,
                                ("attention", 8, 64, 77, 160): 3,
                                ("group_norm", 1, 32, 8, 8): 1})
    run = _Run(_trace(units=1), work)
    k1 = roofline.least_seconds(*roofline.k1_ops_bytes(64, 4096, 4096, 40,
                                                       2))
    assert _readers.kernel_roofline(run, "k1") == pytest.approx(
        100 * k1 / 100e-6)
    k2 = roofline.k2_bytes((1, 32, 8, 8), 2) / roofline.HBM_BYTES_PER_S
    assert _readers.kernel_roofline(run, "k2") == pytest.approx(
        100 * k2 / 50e-6)
    assert _readers.mfu(run) == pytest.approx(
        100 * 1e12 / (1e-3 * roofline.BF16_FLOPS))
    run.work = roofline.Work(1e12, {("attention", 64, 4096, 4096, 40): 2})
    assert _readers.kernel_roofline(run, "k1") is None   # counts disagree
    assert _readers.kernel_roofline(_Run(None, work), "k1") is None


def test_spread_and_percentile():
    assert harness.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)
    vals = list(range(1, 101))
    assert harness.percentile(vals, 90) == 90
    assert harness.percentile(vals + [float("inf")] * 20, 90) == float("inf")


def _full(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def test_a_b8_request_holds_the_kernel_calls_the_port_launches():
    """658 K1 and 2908 K2 launches a B=8 request (the port's structure:
    the codec's encode and decode, and 4 refined frames of 10 UNet calls
    and 2 VAE passes each way)."""
    w = S.request_work(_full("ucf_final_sd14"), 8, 4)
    assert sum(w.k1_calls().values()) == 658
    assert sum(w.k2_calls().values()) == 2908
    assert ("attention", 64, 4096, 4096, 40) in w.k1_calls()
    assert ("attention", 8, 4096, 4096, 512) in w.k1_calls()
    assert 3.5e14 < w.flops < 4.0e14


def test_a_training_step_counts_the_analytic_flops():
    """Forward and backward of the flagship step against 3x the forward's
    products (bench.py's formula), within 2%: the input projection has no
    input gradient, the cross-attention projects the source's extra
    token, and the NCE loss's products are outside the formula."""
    cfg = _full("ucf_final_train")
    tr = {"clips_per_step": 6, "clip_frames": 10, "frame_size": 128}
    b, d, dff, n_enc, n_dec, lat, ts, tt = 6, 2048, 2048, 4, 8, 1024, 11, 10
    fwd = 2.0 * b * (ts * (n_enc * (4 * d * d + 2 * d * dff) + lat * d)
                     + tt * (n_dec * (8 * d * d + 2 * d * dff) + 2 * lat * d))
    attn = 2.0 * b * d * 2 * (n_enc * ts ** 2 + n_dec * (tt ** 2 + tt * ts))
    assert T.step_work(cfg, tr).flops == pytest.approx(3 * (fwd + attn),
                                                       rel=0.02)
