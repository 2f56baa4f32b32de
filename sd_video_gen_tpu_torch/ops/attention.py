"""(BH, T, d) attention: the hand-written CUDA flash kernel and its plain version.

Counterpart of ``sd_video_gen_tpu/ops/attention.py``. The SD UNet's and VAE's
spatial self-attention (up to 4096 tokens at 512px) go through
``flash_attention``, which launches ``csrc/flash_attention.cu`` (online
softmax over key tiles, O(T) memory); ``reference_attention`` is the plain
einsum -> f32 softmax -> einsum version it is held against. ``route`` picks
the kernel's body by shape before launch: a tensor-core body (wgmma + TMA)
where TMA can serve (bf16, or f32 as three TF32 products), the FMA body
otherwise.

Dispatch (``attention``): CPU tensors take the plain version; CUDA tensors
with ``q.shape == k.shape`` always take the kernel. Cross-attention (77
context tokens) stays plain, as in the JAX package. The TPU-measured dispatch
table of the JAX package is not carried over: its numbers say nothing about
this card.

Under a CUDA graph capture (``utils/jit.py``) the launcher runs as it does
eagerly: it builds the TMA tensor maps of the capture's pointers on the host
and passes them by value, so the graph holds them. That is right because a
graph's inputs (static buffers) and intermediates (its pool) keep their
addresses at every replay; ``route`` reads the same pointers' alignment, so
a replay takes the eager body; and ``cuTensorMapEncodeTiled`` is looked up
once, in the warm-up before the capture.

Tensor parallelism (``head_sharded_attention`` and ``_ring_attention`` of
the JAX package): heads are the model axis's unit. A split UNet attention
layer already holds its rank's heads (its ``to_q/k/v`` are column-parallel),
so it calls ``attention`` on the local (B * heads / size, T, d) and nothing
more. The VAE's single head has no heads to split: its layer holds its
rank's slice of the features of q, k and v, and ``sharded_attention`` picks
by ``tp_route``, in the JAX package's order: the batch where it divides the
axis (an all-to-all to batch slices, the kernel on each, and back); else
the tokens, where every rank's block has at least ``RING_MIN_TOKENS``
(ring attention: each rank's query block folds every key/value block as it
passes round the ring, an f32 online softmax in plain matmuls, as JAX's
einsums); else the features gathered on every rank and the kernel on the
whole. ``TP_ROUTES`` counts the choices.
"""

from __future__ import annotations

import collections

import torch

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.parallel import constrain

MAX_HEAD_DIM = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Launches of ``flash_attention`` by body, beside its count in
# ``_kernels.LAUNCHES``: a run can show which body its path took.
ROUTE_LAUNCHES: collections.Counter = collections.Counter()
# The least token block per rank for ring attention: below it the exchanges
# cost more than they split (the JAX package's bound).
RING_MIN_TOKENS = 256
TP_ROUTES: collections.Counter = collections.Counter()


def route(dtype, d: int, data_ptrs) -> str:
    """The kernel body for (dtype, head dim, q/k/v data pointers), where
    TMA can serve (its row stride must be a multiple of 16 bytes, its
    pointers 16-byte aligned): ``"wgmma"`` (bf16 on the tensor cores) for
    bf16 with d a multiple of 8; ``"tf32x3"`` (f32 on the tensor cores as
    three TF32 products, big * big + big * small + small * big, each
    operand split into a TF32 big part and a TF32 small part: within the
    f32 tolerance, where one TF32 product is not) for f32 with d a multiple
    of 4; ``"fma"`` (f32 FMAs, no tensor cores) for everything else."""
    if all(p % 16 == 0 for p in data_ptrs):
        if dtype == torch.bfloat16 and d % 8 == 0:
            return "wgmma"
        if dtype == torch.float32 and d % 4 == 0:
            return "tf32x3"
    return "fma"


def reference_attention(q, k, v, scale: float | None = None):
    """Einsum attention in f32: the CPU path and the kernel's oracle."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: float | None = None):
    """Launch the CUDA kernel on contiguous (BH, T, d) f32/bf16 CUDA tensors.
    Forward only: raises where autograd would have to pass through it
    (``_kernels.refuse_grad``)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must be CUDA tensors")
    _kernels.refuse_grad("flash_attention", q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if q.dim() != 3 or not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention: needs equal (BH, T, d) shapes, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    BH, T, d = q.shape
    if not (1 <= BH <= 65535 and T >= 1 and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} outside "
                         f"BH <= 65535, T >= 1, d <= {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    scale = scale if scale is not None else d ** -0.5
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    body = route(q.dtype, d, ptrs)
    lib = _kernels.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if body in ("wgmma", "tf32x3"):
            err = getattr(lib, f"sdvg_flash_attention_{body}")(
                *ptrs, out.data_ptr(), BH, T, d, float(scale), stream)
        else:
            err = lib.sdvg_flash_attention(
                *ptrs, out.data_ptr(), BH, T, d, float(scale),
                _DTYPE_CODES[q.dtype], stream)
    _kernels.check(err, f"flash_attention ({body})")
    _kernels.count_launch("flash_attention")
    ROUTE_LAUNCHES[body] += 1
    return out


def attention(q, k, v, scale: float | None = None, force: str | None = None):
    """Dispatch (BH, T, d) attention: the kernel for CUDA self-attention; the
    plain version on the CPU, for cross-attention, and with
    ``force='reference'`` or under ``_kernels.force_reference``."""
    if force not in (None, "reference"):
        raise ValueError(f"attention: unknown force={force!r}")
    if q.shape == k.shape:
        _kernels.record("flash_attention", (tuple(q.shape), q.dtype, scale))
    if (q.device.type == "cpu" or force or _kernels.forced()
            or q.shape != k.shape):
        return reference_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no path for device {q.device}")
    # no layout copy here: the launcher raises on a non-contiguous input,
    # and a caller that needs a copy makes it where it can be seen
    return flash_attention(q, k, v, scale)


def tp_route(batch: int, tokens: int, size: int) -> str:
    """How single-head attention over a model axis of ``size`` splits its
    work (the JAX package's order): ``"batch"`` where the batch divides the
    axis; else ``"ring"`` where the tokens do and each rank's block has at
    least ``RING_MIN_TOKENS``; else ``"gather"``."""
    if batch % size == 0:
        return "batch"
    if tokens % size == 0 and tokens // size >= RING_MIN_TOKENS:
        return "ring"
    return "gather"


def sharded_attention(q, k, v, scale: float, shard):
    """Single-head (B, T, C) attention whose q, k, v each rank holds a
    feature slice of, (B, T, C / size): this rank's slice of the output, by
    ``tp_route``. Every rank of the model group calls it together."""
    how = tp_route(q.shape[0], q.shape[1], shard.size)
    TP_ROUTES[how] += 1
    if how == "batch":
        q, k, v = (constrain.features_to_batch(x, shard) for x in (q, k, v))
        return constrain.batch_to_features(attention(q, k, v, scale), shard)
    if how == "ring":
        q, k, v = (constrain.features_to_tokens(x, shard) for x in (q, k, v))
        return constrain.tokens_to_features(
            _ring_attention(q, k, v, scale, shard), shard)
    q, k, v = (constrain.gather_features(x, shard) for x in (q, k, v))
    c = q.shape[-1] // shard.size
    return attention(q, k, v, scale)[..., shard.rank * c:
                                     (shard.rank + 1) * c].contiguous()


def _ring_attention(q, k, v, scale, shard):
    """Sequence-parallel attention: q, k, v are this rank's block of tokens
    (B, T / size, d). The rank folds its own key/value block first, then
    size - 1 times receives the previous rank's (passing its current one
    on, ``constrain.ring_shift``) and folds that: an online softmax with
    f32 running max, normaliser and accumulator; the products as JAX's
    einsums take them (f32 accumulation, the probabilities rounded to v's
    dtype). Non-causal, so the visiting order does not matter."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    B, t, d = q.shape
    qf = q.float()

    def fold(m, l, acc, kb, vb):
        s = torch.matmul(qf, kb.float().transpose(1, 2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(vb.dtype).float(), vb.float())
        return m_new, l, acc

    m, l, acc = fold(torch.full((B, t, 1), -torch.inf, device=q.device),
                     torch.zeros((B, t, 1), device=q.device),
                     torch.zeros((B, t, d), device=q.device), k, v)
    kv = torch.cat([k, v], dim=-1)
    for _ in range(shard.size - 1):
        kv = constrain.ring_shift(kv, shard)
        m, l, acc = fold(m, l, acc, kv[..., :d], kv[..., d:])
    return (acc / l).to(q.dtype)
