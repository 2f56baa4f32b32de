"""Tensor-parallel sharding rules over the port's parameter names
(``sd_video_gen_tpu/parallel/sharding.py``).

Megatron pairs, as the JAX package's rules place them: in each block the
first matmul (or convolution) is column-parallel, its output features split
over the ``model`` axis, and the second row-parallel, its input features
split, so one all-reduce per block brings the residual stream back to every
rank (``parallel/constrain.py``). Everything else is replicated.

  FrameTransformer (``param_shardings``): the q/k/v in-projections and
    ``linear1`` column-parallel; the attention ``out_proj`` and ``linear2``
    row-parallel; embeddings, norms and the output head replicated.
  UNet / VAE (``diffusion_param_shardings``): resnet ``conv1`` and
    ``time_emb_proj`` column-parallel, ``conv2`` row-parallel; attention
    ``to_q/to_k/to_v`` (UNet) and ``query/key/value`` (VAE)
    column-parallel, ``to_out.0`` / ``proj_attn`` row-parallel; the GEGLU
    projection column-parallel and ``ff.net.2`` row-parallel; the time
    embedding's ``linear_1`` column-parallel and ``linear_2`` row-parallel.
    A weight whose split feature dimension does not divide the axis stays
    replicated, as in the JAX rules.

torch weights are (out, in, ...), so a column split cuts dim 0 and a row
split dim 1. Biases: a column-parallel layer's bias is split with its
outputs, a row-parallel layer's is whole on every rank and added once,
after the all-reduce (the JAX package stores every bias whole and lets
GSPMD slice it). The GroupNorm after a split ``conv1`` (``norm2``) runs on
the channel shard, so its affine is split with the channels.

Fused weights are cut part by part: the port's ``in_proj_weight`` holds the
q, k and v rows, and each rank takes its heads' rows of each third (the JAX
package's fused ``qkv`` kernel is one contiguous block of output columns
that GSPMD reshards); the fused GEGLU ``ff.net.0.proj`` holds the ``h`` rows
then the ``gate`` rows (JAX: ``geglu_proj_h`` and ``geglu_proj_gate``), and
each rank takes its slice of each half.

``shard_state_dict`` cuts a whole model's ``state_dict`` into one rank's;
``gather_state_dict`` assembles the whole from every rank's over the model
group (the trainer's checkpoints).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor split over the model axis along ``dim`` (0: output
    features, 1: input features), in ``parts`` equal fused parts each cut
    alike."""
    dim: int
    parts: int = 1


OUT, IN = Placement(0), Placement(1)

_TRANSFORMER = (
    (r"\.(self_attn|multihead_attn)\.in_proj_(weight|bias)$", Placement(0, 3)),
    (r"\.(self_attn|multihead_attn)\.out_proj\.weight$", IN),
    (r"\.linear1\.(weight|bias)$", OUT),
    (r"\.linear2\.weight$", IN),
)
_DIFFUSION = (
    (r"(^|\.)(conv1|time_emb_proj|to_q|to_k|to_v|query|key|value|linear_1)"
     r"\.(weight|bias)$", OUT),
    (r"\.ff\.net\.0\.proj\.(weight|bias)$", Placement(0, 2)),
    (r"\.resnets\.\d+\.norm2\.(weight|bias)$", OUT),
    (r"(^|\.)(conv2|to_out\.0|ff\.net\.2|proj_attn|linear_2)\.weight$", IN),
)
RULES = {"transformer": _TRANSFORMER, "unet": _DIFFUSION, "vae": _DIFFUSION}


def placement(kind: str, name: str, shape, size: int) -> Placement | None:
    """Where parameter ``name`` (whole shape ``shape``) of a ``kind`` model
    ('transformer', 'unet', 'vae') lives on a model axis of ``size``; None:
    replicated. The diffusion models' divisibility rule applies: a split
    feature dimension (per fused part) that ``size`` does not divide stays
    whole. The FrameTransformer has none (its model raises instead)."""
    if size == 1:
        return None
    for pattern, p in RULES[kind]:
        if re.search(pattern, name):
            if kind != "transformer" and (shape[p.dim] // p.parts) % size:
                return None
            return p
    return None


def splits(shard, features: int):
    """``shard`` where a layer whose split dimension has ``features``
    features is cut over the model axis; None where it stays whole (no
    axis, an axis of 1, or the divisibility rule)."""
    if shard is None or shard.size == 1 or features % shard.size:
        return None
    return shard


def check_split(shard, what: str, n: int, unit: str) -> None:
    """Raise where a layer split over ``shard`` would cut one of its ``n``
    ``unit``s (a head, a GroupNorm group) across ranks: GSPMD would
    reshard, the port's per-rank modules cannot."""
    if shard is not None and n % shard.size:
        raise ValueError(f"{what}: a model axis of {shard.size} does not "
                         f"divide its {n} {unit}s")


def placements(kind: str, shapes: dict, size: int) -> dict:
    """``placement`` of every entry of ``shapes`` ({name: whole shape}, a
    ``state_dict`` will do)."""
    return {k: placement(kind, k, tuple(v.shape) if hasattr(v, "shape")
                         else tuple(v), size) for k, v in shapes.items()}


def shard_tensor(t: torch.Tensor, p: Placement | None, rank: int,
                 size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the whole tensor ``t``."""
    if p is None:
        return t
    return torch.cat([part.chunk(size, dim=p.dim)[rank]
                      for part in t.chunk(p.parts, dim=p.dim)], dim=p.dim)


def unshard_tensor(chunks, p: Placement | None) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order."""
    if p is None:
        return chunks[0]
    split = [c.chunk(p.parts, dim=p.dim) for c in chunks]
    return torch.cat([s[j] for j in range(p.parts) for s in split],
                     dim=p.dim)


def full_shape(shape, p: Placement | None, size: int) -> tuple:
    """The whole shape of a rank's slice of ``shape``."""
    shape = tuple(shape)
    if p is None:
        return shape
    return shape[:p.dim] + (shape[p.dim] * size,) + shape[p.dim + 1:]


def shard_state_dict(sd: dict, where: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s ``state_dict`` from a whole one, ``where`` its
    ``placements``."""
    return {k: shard_tensor(v, where.get(k), rank, size)
            for k, v in sd.items()}


def gather_state_dict(local: dict, where: dict, shard) -> dict:
    """The whole ``state_dict`` from every rank's (``local`` this rank's,
    ``where`` the whole model's ``placements``), on every rank of the model
    group: one all-gather per split tensor."""
    out = {}
    for k, v in local.items():
        p = where.get(k)
        if p is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(shard.size)]
        dist.all_gather(parts, v.contiguous(), group=shard.group)
        out[k] = unshard_tensor(parts, p)
    return out
