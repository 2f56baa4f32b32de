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
          trainable: bool = False, shard=None):
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
    the construction, which leaves the caller's random state as it was.

    ``shard`` (a ``parallel.mesh.ModelShard``): this rank's slice of the
    same seeded model (``shard_module``), so a tensor-parallel run starts
    from the weights a single process would."""
    device = default_device(device)
    if shard is not None and shard.size > 1:
        return shard_module(build(module_cls, cfg, device, dtype, seed,
                                  trainable), shard)
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with torch.device(device):
            module = module_cls(cfg)
    module = module.to(device=device, dtype=dtype)
    return module.to(memory_format=torch.channels_last).train(trainable) \
        .requires_grad_(trainable)


def shard_module(whole: torch.nn.Module, shard) -> torch.nn.Module:
    """Rank ``shard.rank``'s tensor-parallel counterpart of ``whole`` (a
    UNet, VAE or FrameTransformer): built with ``shard`` on its device in
    its dtype, memory format and mode, filled with its slice of every split
    weight (``parallel/sharding.py``). ``whole`` is left as it was."""
    from sd_video_gen_tpu_torch.parallel import sharding
    p = next(whole.parameters())
    with torch.device(p.device):
        part = type(whole)(whole.cfg, shard=shard)
    # buffers made from host arrays (the positional table) move too
    part = part.to(device=p.device, dtype=p.dtype).to(
        memory_format=torch.channels_last)
    sd = whole.state_dict()
    where = sharding.placements(type(whole).SHARDING, sd, shard.size)
    with torch.no_grad():
        part.load_state_dict(sharding.shard_state_dict(
            sd, where, shard.rank, shard.size), strict=True)
    return part.train(whole.training).requires_grad_(p.requires_grad)
