"""The port's FVD functions (``sd_video_gen_tpu_torch/evaluation/fvd.py``)
against the JAX package's (``sd_video_gen_tpu/evaluation/fvd.py``) on the
same arrays.

Tolerances: ``preprocess_videos`` within 5e-5 of JAX's in [-1, 1]
(``F.interpolate`` and ``jax.image.resize`` weigh the same two pixels in
f32, in another order); the f64 host statistics and the Fréchet functions
to 1e-10 relative (the same numpy code on the same f64 inputs); a batch's
f32 sums on the device within 1e-5 relative of the f64 ones.
"""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sd_video_gen_tpu.evaluation import fvd as J
from sd_video_gen_tpu_torch.evaluation import fvd as P

PRE_ATOL = 5e-5
F64_RTOL = 1e-10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(2, 3, 64, 64, 3), (1, 2, 128, 128, 3),
                                   (1, 2, 64, 96, 3), (1, 1, 448, 672, 3),
                                   (1, 2, 224, 224, 3)])
def test_preprocess_videos_matches_jax(shape):
    v = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(J.preprocess_videos(jnp.asarray(v)))
    out = P.preprocess_videos(torch.from_numpy(v))
    assert out.shape == (shape[0], 3, shape[1], 224, 224)
    assert out.dtype == torch.float32 and out.is_contiguous()
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(), ref,
                               rtol=0, atol=PRE_ATOL)


def _stats_jax(batches, dim):
    st = J.FeatureStats(dim)
    for b in batches:
        st = st.append(jnp.asarray(b))
    return st


def _close64(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=F64_RTOL,
                               atol=F64_RTOL * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("offset", [0.0, 300.0])
def test_feature_stats_append_merge_and_mean_cov_match_jax(offset):
    """Host f64 accumulation, including the offset-300 case where f32
    would cancel (tests/test_fvd.py)."""
    feats = (np.random.default_rng(1).standard_normal((4000, 8))
             .astype(np.float32) + offset)
    batches = [feats[i:i + 50] for i in range(0, 4000, 50)]
    ref = _stats_jax(batches, 8)
    st = P.FeatureStats(8)
    for b in batches[:40]:
        st = st.append(torch.from_numpy(b))
    rest = P.FeatureStats(8)
    for b in batches[40:]:
        rest = rest.append(b)
    st = st.merge(rest)
    assert st.raw_prod.dtype == np.float64 and float(st.n) == 4000
    for a, b in zip((st.raw_sum, st.raw_prod), (ref.raw_sum, ref.raw_prod)):
        _close64(a, b)
    for a, b in zip(st.mean_cov(), ref.mean_cov()):
        _close64(a, b)
    d = feats.astype(np.float64) - feats.astype(np.float64).mean(0)
    np.testing.assert_allclose(st.mean_cov()[1], d.T @ d / len(feats),
                               rtol=1e-6, atol=1e-6)


def test_of_batch_sums_in_f32_where_the_features_are_and_merges_in_f64():
    feats = (np.random.default_rng(2).standard_normal((64, 16))
             .astype(np.float32) + 3.0)
    one = P.FeatureStats.of_batch(torch.from_numpy(feats))
    assert isinstance(one.raw_prod, torch.Tensor)
    assert one.raw_prod.dtype == torch.float32
    merged = P.FeatureStats(16).merge(one).merge(
        P.FeatureStats.of_batch(torch.from_numpy(feats)))
    assert merged.raw_prod.dtype == np.float64 and float(merged.n) == 128
    ref = _stats_jax([feats, feats], 16)
    np.testing.assert_allclose(merged.raw_prod, ref.raw_prod, rtol=1e-5)
    np.testing.assert_allclose(merged.raw_sum, ref.raw_sum, rtol=1e-5)


def test_frechet_functions_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 12)) * 2 + 1
    y = rng.standard_normal((30, 12)) @ rng.standard_normal((12, 12)) * 0.5
    cx, cy = J.cov_bessel(x), J.cov_bessel(y)
    _close64(P.cov_bessel(x), cx)
    _close64(P._symmetric_sqrt(cx), J._symmetric_sqrt(cx))
    np.testing.assert_allclose(P.trace_sqrt_product(cx, cy),
                               J.trace_sqrt_product(cx, cy), rtol=F64_RTOL)
    np.testing.assert_allclose(P.frechet_distance(x, y),
                               J.frechet_distance(x, y), rtol=F64_RTOL)
    # near-singular: 6 samples of 400 dimensions, as small-sample FVD gives
    a, b = rng.standard_normal((6, 400)), rng.standard_normal((6, 400)) + 0.1
    np.testing.assert_allclose(P.frechet_distance(a, b),
                               J.frechet_distance(a, b), rtol=F64_RTOL)
    assert abs(P.frechet_distance(x, x.copy())) < 1e-6


def test_compute_fvd_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 10)).astype(np.float32) + 50
    y = (rng.standard_normal((300, 10)) * 1.2 + 50.5).astype(np.float32)
    ours = P.compute_fvd(P.FeatureStats(10).append(x),
                         P.FeatureStats(10).append(torch.from_numpy(y)))
    ref = J.compute_fvd(_stats_jax([x], 10), _stats_jax([y], 10))
    np.testing.assert_allclose(ours, ref, rtol=F64_RTOL)


def test_the_two_lineages_agree():
    """Streaming (population covariances) against batch (Bessel): they
    differ by O(1/N)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1000, 8)).astype(np.float32)
    y = (rng.standard_normal((1000, 8)) * 1.3 + 0.5).astype(np.float32)
    batch = P.frechet_distance(x, y)
    stream = P.compute_fvd(P.FeatureStats(8).append(x),
                           P.FeatureStats(8).append(y))
    np.testing.assert_allclose(stream, batch, rtol=0.02)
    np.testing.assert_allclose(stream, J.compute_fvd(_stats_jax([x], 8),
                                                     _stats_jax([y], 8)),
                               rtol=F64_RTOL)


def test_get_fvd_logits_chunks_the_batch():
    """Chunks of ``batch_size`` clips give the logits of one pass."""
    class Mean(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, 400))

        def forward(self, x):
            return x.mean(dim=(2, 3, 4)) @ self.w

    v = np.random.default_rng(6).integers(0, 256, (5, 9, 32, 32, 3),
                                          dtype=np.uint8)
    m = Mean()
    whole = P.get_fvd_logits(m, v, batch_size=16)
    chunks = P.get_fvd_logits(m, v, batch_size=2)
    assert whole.shape == (5, 400)
    torch.testing.assert_close(chunks, whole, rtol=1e-6, atol=1e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = np.asarray(J.preprocess_videos(jnp.asarray(v))).mean(
            axis=(1, 2, 3)) @ np.ones((3, 400), np.float32)
    np.testing.assert_allclose(whole.numpy(), ref, atol=1e-4)
