"""Sinusoidal positional table (``sd_video_gen_tpu/models/positional.py``)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_positions(max_len: int, dim: int) -> torch.Tensor:
    """(max_len, dim) f32: even dims sin(pos * exp(-log(1e4) * 2i/dim)), odd
    dims cos with the paired even-index frequency (the reference formula)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    table = np.zeros((max_len, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: table[:, 1::2].shape[1]])
    return torch.from_numpy(table)
