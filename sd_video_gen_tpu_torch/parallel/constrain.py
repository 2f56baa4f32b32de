"""The collectives of the tensor-parallel modules
(``sd_video_gen_tpu/parallel/constrain.py`` mapped onto explicit
per-rank modules).

JAX's ``tp_constrain`` only pins where GSPMD places an activation, and XLA
inserts the collectives that placement implies. The port's sharded modules
(``models/``) hold only their rank's slice of each split weight, so they
call the collectives themselves, here, each over the ``ModelShard`` they
carry (``parallel/mesh.py``): there is no trace-time context.

  - ``copy_to_model``: entering a column-parallel layer, identity forward,
    all-reduce backward (each rank's input gradient is a partial sum);
  - ``reduce_from_model``: leaving a row-parallel layer, all-reduce forward
    (each rank's product is a partial sum), identity backward;
  - ``features_to_batch`` / ``batch_to_features`` and ``features_to_tokens``
    / ``tokens_to_features``: one ``all_to_all`` that moves a (B, T, C)
    activation between split over its features and split over its batch or
    its tokens; ``gather_features`` assembles the features on every rank;
  - ``ring_shift``: each rank sends a tensor to the next rank of the group
    and receives the previous one's (ring attention's neighbour exchange).

The first two are ``torch.autograd.Function``s, so training runs through
them (the FrameTransformer's model axis, ``train/trainer.py``); the rest
serve the frozen diffusion models. Over NCCL, the card's default, every one
of them is device work with no host sync (``ring_shift``'s send, receive
and waits included), so a compiled program holds them in its graph
(``utils/jit.py``). gloo takes CUDA tensors in its collectives but not in
its point-to-point operations, so ``ring_shift`` stages through host
memory where the group is gloo and the tensor is on a card, and only
there; a program over a gloo group runs eagerly (``jit``'s backend rule).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of ``t``'s memory (an NHWC view of a channels-last
    tensor): what the collectives take, written in place."""
    if t.is_contiguous():
        return t
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1)
    raise ValueError(f"collective on a tensor of strides {t.stride()}: "
                     f"neither contiguous nor channels-last")


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(_dense(t), op=dist.ReduceOp.SUM, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.clone(memory_format=torch.preserve_format),
                            group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, shard) -> torch.Tensor:
    """``x`` (replicated on the model group) entering a column-parallel
    layer: itself; its gradient summed over the group."""
    return _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard) -> torch.Tensor:
    """A row-parallel layer's partial product summed over the model group;
    its gradient passes as it is. Without autograd the sum is written into
    ``x`` (a product the caller made for this), else into a new tensor in
    ``x``'s memory format."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _all_reduce_(x, shard.group)
    return _ReduceFromModel.apply(x, shard.group)


def row_parallel(y: torch.Tensor, bias, shard) -> torch.Tensor:
    """A row-parallel layer's output from its partial product ``y`` (made
    without the bias): summed over the model group, then the bias, once
    (over the channels of a (B, C, H, W) ``y``, else its last dimension)."""
    y = reduce_from_model(y, shard)
    if bias is None:
        return y
    return y + (bias[:, None, None] if y.dim() == 4 else bias)


def _all_to_all(chunks: torch.Tensor, shard) -> torch.Tensor:
    """(size, ...) contiguous: chunk j to rank j; returns (size, ...) with
    chunk i from rank i."""
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=shard.group)
    return out


def features_to_batch(x: torch.Tensor, shard) -> torch.Tensor:
    """(B, T, C/size), this rank's features of every sample -> (B/size, T,
    C), every feature of this rank's samples (contiguous)."""
    s = shard.size
    B, T, c = x.shape
    got = _all_to_all(x.reshape(s, B // s, T, c).contiguous(), shard)
    return got.permute(1, 2, 0, 3).reshape(B // s, T, s * c)


def batch_to_features(y: torch.Tensor, shard) -> torch.Tensor:
    """The inverse of ``features_to_batch``."""
    s = shard.size
    b, T, C = y.shape
    got = _all_to_all(y.reshape(b, T, s, C // s).permute(2, 0, 1, 3)
                      .contiguous(), shard)
    return got.reshape(s * b, T, C // s)


def features_to_tokens(x: torch.Tensor, shard) -> torch.Tensor:
    """(B, T, C/size) -> (B, T/size, C): every feature of this rank's block
    of tokens (contiguous)."""
    s = shard.size
    B, T, c = x.shape
    got = _all_to_all(x.reshape(B, s, T // s, c).permute(1, 0, 2, 3)
                      .contiguous(), shard)
    return got.permute(1, 2, 0, 3).reshape(B, T // s, s * c)


def tokens_to_features(y: torch.Tensor, shard) -> torch.Tensor:
    """The inverse of ``features_to_tokens``."""
    s = shard.size
    B, t, C = y.shape
    got = _all_to_all(y.reshape(B, t, s, C // s).permute(2, 0, 1, 3)
                      .contiguous(), shard)
    return got.permute(1, 0, 2, 3).reshape(B, s * t, C // s)


def gather_features(x: torch.Tensor, shard) -> torch.Tensor:
    """(B, T, C/size) -> (B, T, C) on every rank of the group."""
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x.contiguous(), group=shard.group)
    return torch.cat(parts, dim=-1)


def ring_shift(x: torch.Tensor, shard) -> torch.Tensor:
    """``x`` sent to the next rank of the model group, the previous rank's
    returned: one send and one receive, in one ``batch_isend_irecv``."""
    group = shard.group
    peer = lambda r: dist.get_global_rank(group, r % shard.size)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer(shard.rank + 1), group),
            dist.P2POp(dist.irecv, recv, peer(shard.rank - 1), group)]):
        req.wait()
    return recv.to(x.device) if staged else recv
