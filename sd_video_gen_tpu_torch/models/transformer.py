"""The frame-latent seq2seq transformer family in PyTorch.

Counterpart of ``sd_video_gen_tpu/models/transformer.py``. One model with
mode flags:

  - 'ar': teacher-forced next-frame AR;
  - 'future': k-step single shot; adds a ``learned_tgt`` parameter
    (1, K, latent_dim) that checkpoints carry and the forward does not use;
  - 'learned_tgt': DETR-style learnable queries; the decoder input is
    LN(zeros) + ``query_pos``, built in latent space and then embedded;
  - 'text': a class-name text embedding concatenated to every token, so the
    transformer is ``dim_model + text_embed_dim`` wide (``model_width``);
    the embeddings come from ``models/text_embed.py`` in the caller.

'diff' (residual prediction) is a strategy of the caller, not a model.
Semantics of torch ``nn.Transformer`` defaults: post-LN, ReLU,
dim_feedforward 2048, LayerNorm eps 1e-5, a final LayerNorm after each
stack; embedding * sqrt(D) plus the sinusoidal table; dropout
(``dropout_p``) on the attention weights, after the feed-forward's ReLU, on
every residual branch and on the embedded inputs, as the JAX model has it.
Dropout runs only in ``train()`` mode, and draws from the ``torch.Generator``
handed to the forward, never from the global one: the train step seeds it
from (seed, step), so a resumed run draws what an uninterrupted one would.
An ``eval()`` forward has no dropout and needs no generator.

Precisions, as the JAX model's ``dtype`` / ``param_dtype``: the compute dtype
is ``cfg.compute_dtype``, or the parameters' own where that is ``None``.
Linear layers compute in it (input, weight and bias cast to it: bf16 compute
on f32 master parameters is ``compute_dtype=torch.bfloat16`` on an f32
module); LayerNorms run in the parameters' dtype (f32 statistics inside) and
the softmax in f32. Parameter names follow the reference's own ``nn.Transformer``
state_dict (``transformer.encoder.layers.0.self_attn.in_proj_weight``,
``...multihead_attn...``, ``linear1``, ``norm1``, ``transformer.decoder.norm``;
``learned_tgt``, ``query_pos`` with its LayerNorm ``norm``,
``project_image_embedding`` in place of ``embedding`` in text mode),
so its checkpoints map one to one. Sequences are <= 16 frame tokens: the
attention here is plain PyTorch.

Tensor parallelism (``shard``, a ``parallel.mesh.ModelShard`` of size > 1;
the rules of ``parallel/sharding.py``): every attention layer holds its
rank's heads (its rows of each of the q, k and v thirds of
``in_proj_weight``) and ``out_proj`` sums them over the model group; the
feed-forward holds its rank's hidden features (``linear1`` column-, ``linear2``
row-parallel); embeddings, norms and the output head are whole on every
rank, on the replicated residual stream. Dropout there acts on replicated
activations, so its masks must be the same on every rank of the model
group: they come from ``generator``. The dropout on the attention weights
and on the feed-forward's hidden features acts on this rank's heads and
features: those masks come from ``local_generator``, which the trainer
seeds per model rank. Without a shard both are one generator and the
model is the plain one.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sd_video_gen_tpu_torch.models.positional import sinusoidal_positions
from sd_video_gen_tpu_torch.ops.losses import wide
from sd_video_gen_tpu_torch.parallel.constrain import (copy_to_model,
                                                       row_parallel)
from sd_video_gen_tpu_torch.parallel.sharding import check_split


@dataclasses.dataclass(frozen=True)
class FrameTransformerConfig:
    latent_dim: int              # 4 * (frame_size/8)^2 flattened SD latent
    dim_model: int = 2048
    num_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 8
    dropout_p: float = 0.1
    dim_feedforward: int = 2048  # torch nn.Transformer default
    max_len: int = 64            # positional table window
    mode: str = "ar"             # ar | future | learned_tgt | text
    frames_to_predict: int = 5   # used by future / learned_tgt modes
    text_embed_dim: int = 384    # MiniLM-L6-v2 embedding width (text mode)
    pe_mode: str = "timestep"    # 'timestep' | 'reference_batch'
    #   'reference_batch' reproduces the reference's PositionalEncoding bug
    #   (PE(batch index) added to every timestep of that item), as the JAX
    #   package does for converted reference checkpoints.
    compute_dtype: torch.dtype | None = None   # None: the parameters' dtype

    def __post_init__(self):
        if self.mode not in ("ar", "future", "learned_tgt", "text"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.model_width % self.num_heads:
            raise ValueError(
                f"model width {self.model_width} (dim_model"
                f"{'+text_embed_dim' if self.mode == 'text' else ''}) must be "
                f"divisible by num_heads={self.num_heads}")
        if self.pe_mode not in ("timestep", "reference_batch"):
            raise ValueError(f"unknown pe_mode {self.pe_mode!r}")

    @property
    def model_width(self) -> int:
        """The transformer's width: text mode concatenates the text
        embedding to every token."""
        if self.mode == "text":
            return self.dim_model + self.text_embed_dim
        return self.dim_model

    @classmethod
    def from_config(cls, cfg, mode: str = "ar",
                    **kw) -> "FrameTransformerConfig":
        return cls(
            latent_dim=cfg.latent_dim,
            dim_model=cfg.dim_model,
            num_heads=cfg.num_heads,
            num_encoder_layers=cfg.num_encoder_layers,
            num_decoder_layers=cfg.num_decoder_layers,
            dropout_p=cfg.dropout_p,
            mode=mode,
            frames_to_predict=cfg.frames_to_predict,
            **kw,
        )


class _Ctx:
    """What one forward hands every layer: the compute dtype and the dropout
    (rate and generator; ``generator=None`` means none is applied).
    ``local`` is the context of the dropout on a model rank's own heads and
    features: one of its own with ``local_generator``, else this one."""

    def __init__(self, dtype, p: float, generator, local_generator=None):
        self.dtype, self.p, self.generator = dtype, p, generator
        self.local = (self if local_generator is None
                      else _Ctx(dtype, p, local_generator))

    def drop(self, x):
        """Inverted dropout in x's dtype: zero with probability p, the rest
        divided by 1 - p."""
        if self.generator is None:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep

    def linear(self, lin: nn.Linear, x):
        dt = self.dtype
        return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))

    def row_linear(self, lin: nn.Linear, x, shard):
        """A row-parallel ``lin`` on this rank's features ``x``: the
        partial products summed over the model group, then the bias."""
        dt = self.dtype
        return row_parallel(F.linear(x.to(dt), lin.weight.to(dt)),
                            lin.bias.to(dt), shard)


def _ln(norm: nn.LayerNorm, x):
    return norm(x.to(norm.weight.dtype))


class MultiheadAttention(nn.Module):
    """Fused in-projection (q|k|v rows of ``in_proj_weight``), additive mask."""

    def __init__(self, dim: int, heads: int, shard=None):
        super().__init__()
        self.shard = shard
        check_split(shard, f"attention of width {dim}", heads, "head")
        w = shard.size if shard is not None else 1
        self.heads = heads // w               # this rank's
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim // w, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim // w))
        self.out_proj = nn.Linear(dim // w, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, kv_in, ctx: _Ctx, mask=None):
        D = self.in_proj_weight.shape[0] // 3      # this rank's heads' width
        dt = ctx.dtype
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        self_attn = q_in is kv_in
        if self.shard is not None:
            q_in = copy_to_model(q_in, self.shard)
            kv_in = q_in if self_attn else copy_to_model(kv_in, self.shard)
        if self_attn:
            q, k, v = F.linear(q_in.to(dt), w, b).chunk(3, dim=-1)
        else:
            q = F.linear(q_in.to(dt), w[:D], b[:D])
            k, v = F.linear(kv_in.to(dt), w[D:], b[D:]).chunk(2, dim=-1)
        B, Tq, _ = q.shape
        H, hd = self.heads, D // self.heads
        q = q.reshape(B, Tq, H, hd)
        k = k.reshape(B, -1, H, hd)
        v = v.reshape(B, -1, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k))
        logits = logits / math.sqrt(hd)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        weights = ctx.local.drop(torch.softmax(logits, dim=-1)).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", wide(weights), wide(v))
        out = out.reshape(B, Tq, D)
        if self.shard is None:
            return ctx.linear(self.out_proj, out)
        return ctx.row_linear(self.out_proj, out, self.shard)


def _ffn(layer, x, ctx: _Ctx):
    if layer.shard is None:
        h = ctx.local.drop(F.relu(ctx.linear(layer.linear1, x)))
        return ctx.linear(layer.linear2, h)
    x = copy_to_model(x, layer.shard)
    h = ctx.local.drop(F.relu(ctx.linear(layer.linear1, x)))
    return ctx.row_linear(layer.linear2, h, layer.shard)


def _ffn_layers(layer, cfg: "FrameTransformerConfig", shard) -> None:
    D, F_ = cfg.model_width, cfg.dim_feedforward
    check_split(shard, "the feed-forward", F_, "hidden feature")
    w = shard.size if shard is not None else 1
    layer.shard = shard
    layer.linear1 = nn.Linear(D, F_ // w)
    layer.linear2 = nn.Linear(F_ // w, D)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig, shard=None):
        super().__init__()
        D = cfg.model_width
        self.self_attn = MultiheadAttention(D, cfg.num_heads, shard)
        _ffn_layers(self, cfg, shard)
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)

    def forward(self, x, ctx: _Ctx):
        x = _ln(self.norm1, x + ctx.drop(self.self_attn(x, x, ctx)))
        return _ln(self.norm2, x + ctx.drop(_ffn(self, x, ctx)))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig, shard=None):
        super().__init__()
        D = cfg.model_width
        self.self_attn = MultiheadAttention(D, cfg.num_heads, shard)
        self.multihead_attn = MultiheadAttention(D, cfg.num_heads, shard)
        _ffn_layers(self, cfg, shard)
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)
        self.norm3 = nn.LayerNorm(D, eps=1e-5)

    def forward(self, x, memory, tgt_mask, ctx: _Ctx):
        x = _ln(self.norm1, x + ctx.drop(self.self_attn(x, x, ctx, tgt_mask)))
        x = _ln(self.norm2, x + ctx.drop(self.multihead_attn(x, memory, ctx)))
        return _ln(self.norm3, x + ctx.drop(_ffn(self, x, ctx)))


class _Stack(nn.Module):
    def __init__(self, layers, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class _Seq2Seq(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig, shard=None):
        super().__init__()
        D = cfg.model_width
        self.encoder = _Stack([EncoderLayer(cfg, shard)
                               for _ in range(cfg.num_encoder_layers)], D)
        self.decoder = _Stack([DecoderLayer(cfg, shard)
                               for _ in range(cfg.num_decoder_layers)], D)


class FrameTransformer(nn.Module):
    """Seq2seq encoder-decoder over flattened frame latents, batch-first.

    ``model(src, tgt, tgt_mask=None, text_embeds=None, generator=None,
    local_generator=None)`` -> (B, T_tgt, latent_dim) f32. ``text_embeds``
    (B, text_embed_dim) is required in text mode and ignored otherwise;
    'learned_tgt' ignores ``tgt`` and decodes its ``frames_to_predict``
    queries. In ``train()`` mode with ``dropout_p > 0`` the forward needs
    ``generator`` (on the inputs' device) for its dropout draws, and takes
    the draws on a model rank's own heads and features from
    ``local_generator`` where one is given (module docstring); in ``eval()``
    mode both are ignored. ``shard``: this rank's place on the model axis.
    """

    SHARDING = "transformer"   # its rules in parallel/sharding.py

    def __init__(self, cfg: FrameTransformerConfig, shard=None):
        super().__init__()
        if shard is not None and shard.size == 1:
            shard = None
        self.cfg = cfg
        D, L, K = cfg.model_width, cfg.latent_dim, cfg.frames_to_predict
        if cfg.mode == "future":
            self.learned_tgt = nn.Parameter(torch.randn(1, K, L))
        if cfg.mode == "learned_tgt":
            self.query_pos = nn.Parameter(torch.rand(K, L))
            self.norm = nn.LayerNorm(L, eps=1e-5)
        if cfg.mode == "text":
            self.project_image_embedding = nn.Linear(L, cfg.dim_model)
        else:
            self.embedding = nn.Linear(L, D)
        self.transformer = _Seq2Seq(cfg, shard)
        self.out = nn.Linear(D, L)
        self.register_buffer("pos_table", sinusoidal_positions(cfg.max_len, D),
                             persistent=False)

    def forward(self, src, tgt, tgt_mask=None, text_embeds=None,
                generator: torch.Generator | None = None,
                local_generator: torch.Generator | None = None):
        cfg = self.cfg
        dt = cfg.compute_dtype or self.out.weight.dtype
        dropping = self.training and cfg.dropout_p > 0
        if dropping and generator is None:
            raise ValueError("a train() forward with dropout_p > 0 needs a "
                             "torch.Generator for its dropout draws")
        ctx = _Ctx(dt, cfg.dropout_p, generator if dropping else None,
                   local_generator if dropping else None)
        scale = math.sqrt(cfg.model_width)
        if cfg.mode == "learned_tgt":
            q = self.norm(torch.zeros_like(self.query_pos)) + self.query_pos
            tgt = q[None].expand(src.shape[0], -1, -1)
        if cfg.mode == "text":
            if text_embeds is None:
                raise ValueError(
                    "text mode requires text_embeds (B, text_embed_dim)")
            t = text_embeds.to(dt)[:, None]
            proj = self.project_image_embedding
            src = torch.cat([ctx.linear(proj, src),
                             t.expand(-1, src.shape[1], -1)], dim=-1) * scale
            tgt = torch.cat([ctx.linear(proj, tgt),
                             t.expand(-1, tgt.shape[1], -1)], dim=-1) * scale
        else:
            src = ctx.linear(self.embedding, src) * scale
            tgt = ctx.linear(self.embedding, tgt) * scale
        pe = self.pos_table.to(dt)
        if cfg.pe_mode == "reference_batch":
            src = src + pe[: src.shape[0]][:, None, :]
            tgt = tgt + pe[: tgt.shape[0]][:, None, :]
        else:
            src = src + pe[None, : src.shape[1]]
            tgt = tgt + pe[None, : tgt.shape[1]]
        src, tgt = ctx.drop(src), ctx.drop(tgt)

        memory = src
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, ctx)
        memory = _ln(self.transformer.encoder.norm, memory)
        x = tgt
        for layer in self.transformer.decoder.layers:
            x = layer(x, memory, tgt_mask, ctx)
        x = _ln(self.transformer.decoder.norm, x)
        return wide(ctx.linear(self.out, x))
