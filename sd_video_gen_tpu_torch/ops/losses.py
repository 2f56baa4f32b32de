"""Latent-space training losses (``sd_video_gen_tpu/ops/losses.py``).

  - MSE / L1: mean reduction;
  - gradient-difference loss: | |grad pred| - |grad target| | ** alpha summed
    over the vertical and horizontal differences, over the *flattened*
    element count of ``pred`` (not the count of differences);
  - BiPatchNCE: patches of the same (frame, position) are positives; the
    gradient is stopped through the second operand on negative pairs;
    cross-entropy over the h*w-way logits in both directions, averaged;
  - composite: use_mse*MSE + use_l1*L1 + use_gdl*lambda*GDL +
    use_contrastive*lambda_c*BiPatchNCE.

All take batch-first ``(B, K, latent_dim)`` tensors, ``latent_dim = 4*h*w``
a flattened SD frame latent, and compute in float32 whatever the model's
compute dtype (``wide``: in float64 where the inputs are, the f64
reference step of ``tools/split_check.py``).
"""

from __future__ import annotations

import dataclasses

import torch


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is where it is float64: the precision the
    losses and the FrameTransformer's attention compute in (bf16 and f32
    inputs give exactly ``x.float()``)."""
    return x if x.dtype == torch.float64 else x.float()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (wide(pred) - wide(target)).square().mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (wide(pred) - wide(target)).abs().mean()


def _to_spatial(x: torch.Tensor) -> torch.Tensor:
    """(..., 4*h*w) -> (..., 4, h, w) with h == w (SD latent layout)."""
    hw = int(round((x.shape[-1] // 4) ** 0.5))
    return x.reshape(x.shape[:-1] + (4, hw, hw))


def gradient_difference_loss(pred: torch.Tensor, target: torch.Tensor,
                             alpha: float = 1.0) -> torch.Tensor:
    x = _to_spatial(wide(pred))
    y = _to_spatial(wide(target))
    gvx = x[..., 1:, :] - x[..., :-1, :]
    gvy = y[..., 1:, :] - y[..., :-1, :]
    ghx = x[..., :, 1:] - x[..., :, :-1]
    ghy = y[..., :, 1:] - y[..., :, :-1]
    v = (gvx.abs() - gvy.abs()).abs()
    h = (ghx.abs() - ghy.abs()).abs()
    gd = v.pow(alpha).sum() + h.pow(alpha).sum()
    return gd / pred.numel()


def bipatch_nce_loss(pred: torch.Tensor, target: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """pred / target: (B, K, latent_dim); inside, (B*K, h*w, 4) patch
    features."""
    p = _to_spatial(wide(pred))                       # (B, K, C, h, w)
    g = _to_spatial(wide(target))
    B, K, C, h, w = p.shape
    p = p.reshape(B * K, C, h * w).transpose(1, 2)      # (M, P, C)
    g = g.reshape(B * K, C, h * w).transpose(1, 2)

    def _dir(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # Off-diagonal scores stop the gradient through b; the diagonal
        # keeps it, so it is computed apart as an (M, P) row product and
        # written over the detached product's diagonal.
        s_sg = torch.einsum("mpc,mqc->mpq", a, b.detach())
        diag = (a * b).sum(-1)                          # (M, P)
        d_sg = torch.diagonal(s_sg, dim1=-2, dim2=-1)
        scores = (s_sg + torch.diag_embed(diag - d_sg)) / temperature
        logz = torch.logsumexp(scores, dim=-1)          # (M, P)
        return (logz - torch.diagonal(scores, dim1=-2, dim2=-1)).mean()

    return 0.5 * (_dir(g, p) + _dir(p, g))


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Static loss-mix configuration (one per training run)."""
    use_mse: bool = True
    use_l1: bool = False
    use_gdl: bool = True
    lambda_gdl: float = 1.0
    alpha: float = 1.0
    use_contrastive: bool = True
    lambda_contrastive: float = 0.025
    temperature: float = 0.07

    @classmethod
    def from_config(cls, cfg) -> "LossWeights":
        return cls(
            use_mse=cfg.use_mse, use_l1=cfg.use_l1,
            use_gdl=cfg.use_gdl, lambda_gdl=cfg.lambda_gdl, alpha=cfg.alpha,
            use_contrastive=cfg.use_contrastive,
            lambda_contrastive=cfg.lambda_contrastive,
            temperature=cfg.temperature,
        )


def composite_loss(pred: torch.Tensor, target: torch.Tensor,
                   w: LossWeights) -> tuple[torch.Tensor, dict]:
    """(total, components): the components are always kept for the metrics
    logger, under the keys ``mse``, ``l1``, ``gdl``, ``contrastive`` (those
    switched on) and ``total``."""
    comps = {}
    total = torch.zeros((), dtype=wide(pred).dtype, device=pred.device)
    if w.use_mse:
        comps["mse"] = mse_loss(pred, target)
        total = total + comps["mse"]
    if w.use_l1:
        comps["l1"] = l1_loss(pred, target)
        total = total + comps["l1"]
    if w.use_gdl:
        comps["gdl"] = gradient_difference_loss(pred, target, w.alpha)
        total = total + w.lambda_gdl * comps["gdl"]
    if w.use_contrastive:
        comps["contrastive"] = bipatch_nce_loss(pred, target, w.temperature)
        total = total + w.lambda_contrastive * comps["contrastive"]
    comps["total"] = total
    return total, comps
