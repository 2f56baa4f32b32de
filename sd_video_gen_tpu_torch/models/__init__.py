"""The port's models. ``build`` makes one with seeded random weights."""

from __future__ import annotations

import torch


def build(module_cls, cfg, device=None, dtype=torch.float32, seed: int = 0):
    """``module_cls(cfg)`` initialised from ``seed`` directly on ``device``
    (a full-width UNet is never materialised on the host first), cast to
    ``dtype``, in eval mode with gradients off."""
    device = torch.device(device or "cpu")
    with torch.device(device):
        torch.manual_seed(seed)
        module = module_cls(cfg)
    return module.to(device=device, dtype=dtype).eval().requires_grad_(False)
