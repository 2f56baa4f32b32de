"""FVD (Fréchet Video Distance) over I3D features
(``sd_video_gen_tpu/evaluation/fvd.py``).

Two lineages, as the reference kept them as a cross-check:
  - streaming: ``FeatureStats`` (n, Σx, Σxxᵀ) accumulators and
    ``compute_fvd`` from their population covariances;
  - batch: the logits of every clip collected and ``frechet_distance`` with
    Bessel-corrected covariances.
Both take tr sqrt(C1 C2) through the eigh-based PSD square root
(``_symmetric_sqrt``): LAPACK's SVD can fail to converge, and Schur sqrtm
stalls, on the near-singular products that small-sample FVD produces.

Accumulation: a batch's sums may be taken on the device in f32
(``FeatureStats.of_batch``); every merge across batches and ``mean_cov`` run
on the host in f64. I3D logits are not zero-centred, so over thousands of
clips Σxxᵀ reaches 1e6-1e7 and the population-covariance subtraction would
cancel away most of f32's digits.

The Fréchet functions are numpy in both packages; this module keeps its own
copy.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.utils.jit import jit


# -- preprocessing ----------------------------------------------------------

def preprocess_videos(videos_u8: torch.Tensor, target: int = 224
                      ) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (B, 3, T, target, target) f32 in [-1, 1],
    the I3D input.

    Bilinear resize of the shorter side to ``target`` (half-pixel centres, no
    antialias: the VideoGPT FVD preprocessing), centre crop, scale."""
    B, T, H, W, C = videos_u8.shape
    x = videos_u8.float().reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    scale = target / min(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=False)
    top, left = (nh - target) // 2, (nw - target) // 2
    x = x[:, :, top:top + target, left:left + target] / 127.5 - 1.0
    return x.reshape(B, T, C, target, target).permute(0, 2, 1, 3, 4) \
        .contiguous()


# -- I3D feature extraction -------------------------------------------------

@functools.lru_cache(maxsize=1)
def jitted_features(i3d):
    """``i3d(preprocess_videos(v))`` as one compiled program of this module
    (``utils/jit.py``: a CUDA graph per clip shape on the card), kept for
    the next calls as the JAX package's ``_jitted_features`` keeps one per
    flax module. One module's: its graphs hold their memory pool, so
    another module's first call frees them."""
    return jit(lambda v: i3d(preprocess_videos(v)), name="features")


@torch.no_grad()
def get_fvd_logits(i3d, videos_u8, batch_size: int = 16) -> torch.Tensor:
    """uint8 videos (B, T, H, W, 3) -> (B, num_classes) I3D logits, in chunks
    of ``batch_size`` clips, on the I3D's device: each chunk copied there,
    then ``jitted_features(i3d)`` (a ragged last chunk is a second
    program)."""
    device = next(i3d.parameters()).device
    videos = torch.as_tensor(videos_u8)
    features = jitted_features(i3d)
    outs = [features(videos[i:i + batch_size].to(device))
            for i in range(0, videos.shape[0], batch_size)]
    return torch.cat(outs)


# -- streaming statistics ---------------------------------------------------

def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x, np.float64)


@dataclasses.dataclass
class FeatureStats:
    """Streaming (n, Σx, Σxxᵀ) accumulators.

    ``FeatureStats(dim)`` starts empty on the host (f64). ``append`` adds a
    batch of features in f64 on the host; ``of_batch`` takes one batch's
    sums where the features are (f32 on the device), and ``merge`` brings
    both sides to the host in f64 before adding."""

    dim: int
    n: object = None
    raw_sum: object = None
    raw_prod: object = None

    def __post_init__(self):
        if self.n is None:
            self.n = np.float64(0.0)
            self.raw_sum = np.zeros((self.dim,), np.float64)
            self.raw_prod = np.zeros((self.dim, self.dim), np.float64)

    @classmethod
    def of_batch(cls, feats: torch.Tensor) -> "FeatureStats":
        """One batch's accumulators, computed in f32 where ``feats`` lie."""
        f = feats.float()
        return cls(f.shape[1], f.shape[0], f.sum(0), f.T @ f)

    def append(self, feats) -> "FeatureStats":
        f = _f64(feats)
        return FeatureStats(self.dim, _f64(self.n) + f.shape[0],
                            _f64(self.raw_sum) + f.sum(0),
                            _f64(self.raw_prod) + f.T @ f)

    def merge(self, other: "FeatureStats") -> "FeatureStats":
        return FeatureStats(self.dim, _f64(self.n) + _f64(other.n),
                            _f64(self.raw_sum) + _f64(other.raw_sum),
                            _f64(self.raw_prod) + _f64(other.raw_prod))

    def mean_cov(self):
        """(mean, population covariance), on the host in f64: the
        Σxxᵀ / n - μμᵀ subtraction is where f32 would cancel."""
        n = _f64(self.n)
        mu = _f64(self.raw_sum) / n
        return mu, _f64(self.raw_prod) / n - np.outer(mu, mu)


# -- Fréchet distance -------------------------------------------------------

def _symmetric_sqrt(mat: np.ndarray) -> np.ndarray:
    """PSD matrix square root through eigh of the symmetrised matrix."""
    m = np.asarray(mat, np.float64)
    w, v = np.linalg.eigh((m + m.T) / 2)
    return (v * np.sqrt(np.maximum(w, 0))) @ v.T


def trace_sqrt_product(c1: np.ndarray, c2: np.ndarray) -> float:
    """tr(sqrt(c1 c2)) as tr(sqrt(sqrt(c1) c2 sqrt(c1)))."""
    s1 = _symmetric_sqrt(c1)
    inner = s1 @ np.asarray(c2, np.float64) @ s1
    return float(np.trace(_symmetric_sqrt(inner)))


def cov_bessel(x: np.ndarray) -> np.ndarray:
    """Sample covariance with 1/(N-1)."""
    x = np.asarray(x, np.float64)
    d = x - x.mean(0, keepdims=True)
    return d.T @ d / (x.shape[0] - 1)


def frechet_distance(x: np.ndarray, y: np.ndarray) -> float:
    """FVD from two logit sets: ||mx-my||² + tr(cx + cy - 2 sqrt(cx cy))."""
    x, y = _f64(x), _f64(y)
    mx, my = x.mean(0), y.mean(0)
    cx, cy = cov_bessel(x), cov_bessel(y)
    return float(((mx - my) ** 2).sum() + np.trace(cx) + np.trace(cy)
                 - 2 * trace_sqrt_product(cx, cy))


def compute_fvd(stats_real: FeatureStats, stats_gen: FeatureStats) -> float:
    """Fréchet distance from the streaming accumulators (population
    covariances), on the host in f64."""
    mu_r, cov_r = stats_real.mean_cov()
    mu_g, cov_g = stats_gen.mean_cov()
    m = np.square(mu_g - mu_r).sum()
    return float(m + np.trace(cov_g) + np.trace(cov_r)
                 - 2 * trace_sqrt_product(cov_g, cov_r))
