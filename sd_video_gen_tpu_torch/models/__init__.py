"""The port's models. ``build`` makes one with seeded random weights."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and raises
    where there is none: the CPU has to be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                               "the host")
        device = "cuda"
    return torch.device(device)


def build(module_cls, cfg, device=None, dtype=torch.float32, seed: int = 0,
          trainable: bool = False):
    """``module_cls(cfg)`` initialised from ``seed`` directly on ``device``
    (a full-width UNet is never materialised on the host first), cast to
    ``dtype``, 4-D (convolution) weights in ``torch.channels_last``, in eval
    mode with gradients off; ``trainable=True`` returns it in train mode with
    gradients on instead (the trainer's transformer: every other module of a
    training run stays frozen).

    ``device`` defaults to the card and the call raises where there is none:
    the CPU has to be asked for. The modules' own initialisers
    (``reset_parameters``) draw from torch's global generators and take no
    ``torch.Generator``, so the seed goes to those; they are forked around
    the construction, which leaves the caller's random state as it was."""
    device = default_device(device)
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with torch.device(device):
            module = module_cls(cfg)
    module = module.to(device=device, dtype=dtype)
    return module.to(memory_format=torch.channels_last).train(trainable) \
        .requires_grad_(trainable)
