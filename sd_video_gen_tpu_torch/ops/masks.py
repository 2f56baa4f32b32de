"""Additive attention masks (``sd_video_gen_tpu/ops/masks.py``)."""

from __future__ import annotations

import torch


def causal_mask(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """0 on/below the diagonal, -inf above: row i attends to positions <= i."""
    m = torch.full((size, size), float("-inf"), dtype=dtype, device=device)
    return torch.triu(m, diagonal=1)
