"""Weights and noise from the run's seed, made on the device.

Each model's parameters, listed by name and shape (sorted by name), are
drawn as one standard normal stream from a ``torch.Generator`` seeded from
the run's seed and the model's name, a few large draws in the dtype they
are served in, and scaled in place: a matrix or convolution kernel by
1 / sqrt(3 * fan_in) (the spread of PyTorch's default initialisation), a
norm's weight to 1 + 0.05 z, every other vector to 0.02 z; a
configuration's ``init_spread`` multiplies the spread of the parameters it
names. The same seed
and names give the same tensors, so the plain reference draws its copy
again after the measured program is freed.
"""

from __future__ import annotations

import hashlib
import math

import torch

CHUNK = 1 << 28        # elements a draw


def mix(*parts) -> int:
    """A 63-bit generator seed from the run's seed and names."""
    h = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _scale(name: str, shape) -> tuple[float, float]:
    """(offset, spread) of a parameter's values."""
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return 0.0, 1.0 / math.sqrt(3.0 * fan_in)
    if name.endswith("weight"):
        return 1.0, 0.05
    return 0.0, 0.02


def seeded(named_shapes, seed: int, tag: str, device, dtype,
           spread: dict | None = None) -> dict:
    """name -> tensor for ``named_shapes`` ((name, shape) pairs), drawn from
    ``seed`` and ``tag`` on ``device`` in ``dtype``; ``spread`` multiplies
    the spread of the parameters it names."""
    spread = spread or {}
    items = sorted((n, tuple(s)) for n, s in named_shapes)
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, tag))
    out, batch, size = {}, [], 0

    def draw():
        nonlocal batch, size
        flat = torch.randn(size, generator=g, device=device, dtype=dtype)
        at = 0
        for name, shape in batch:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            offset, sigma = _scale(name, shape)
            t.mul_(sigma * spread.get(name, 1.0))
            if offset:
                t.add_(offset)
            out[name] = t
            at += n
        batch, size = [], 0

    for name, shape in items:
        if size and size + math.prod(shape) > CHUNK:
            draw()
        batch.append((name, shape))
        size += math.prod(shape)
    if batch:
        draw()
    return out


def shapes_of(module: torch.nn.Module) -> list:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``module``'s parameters in place; the names and
    shapes must be the same on both sides."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights: names differ from the module's: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"weights: {name} is {tuple(p.shape)} in the "
                             f"module, {tuple(weights[name].shape)} drawn")
        p.copy_(weights[name])


def noise(seed: int, step: int, shape, device) -> torch.Tensor:
    """The refiner's NHWC noise of rollout step ``step``, float32."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "refiner_noise", step))
    return torch.randn(tuple(shape), generator=g, device=device)
