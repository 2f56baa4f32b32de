"""The frame-latent seq2seq transformer (mode 'ar') in PyTorch.

Counterpart of ``sd_video_gen_tpu/models/transformer.py`` for the AR serving
path. Semantics of torch ``nn.Transformer`` defaults: post-LN, ReLU,
dim_feedforward 2048, LayerNorm eps 1e-5, a final LayerNorm after each
stack; embedding * sqrt(D) plus the sinusoidal table. Inference only (no
dropout). Parameter names follow the reference's own ``nn.Transformer``
state_dict (``transformer.encoder.layers.0.self_attn.in_proj_weight``,
``...multihead_attn...``, ``linear1``, ``norm1``, ``transformer.decoder.norm``),
so its checkpoints map one to one. Sequences are <= 16 frame tokens: the
attention here is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sd_video_gen_tpu_torch.models.positional import sinusoidal_positions


@dataclasses.dataclass(frozen=True)
class FrameTransformerConfig:
    latent_dim: int              # 4 * (frame_size/8)^2 flattened SD latent
    dim_model: int = 2048
    num_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 8
    dim_feedforward: int = 2048  # torch nn.Transformer default
    max_len: int = 64            # positional table window
    pe_mode: str = "timestep"    # 'timestep' | 'reference_batch'
    #   'reference_batch' reproduces the reference's PositionalEncoding bug
    #   (PE(batch index) added to every timestep of that item), as the JAX
    #   package does for converted reference checkpoints.

    def __post_init__(self):
        if self.dim_model % self.num_heads:
            raise ValueError(f"dim_model {self.dim_model} must be divisible "
                             f"by num_heads={self.num_heads}")
        if self.pe_mode not in ("timestep", "reference_batch"):
            raise ValueError(f"unknown pe_mode {self.pe_mode!r}")


class MultiheadAttention(nn.Module):
    """Fused in-projection (q|k|v rows of ``in_proj_weight``), additive mask."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, kv_in, mask=None):
        D = q_in.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        if q_in is kv_in:
            q, k, v = F.linear(q_in, w, b).chunk(3, dim=-1)
        else:
            q = F.linear(q_in, w[:D], b[:D])
            k, v = F.linear(kv_in, w[D:], b[D:]).chunk(2, dim=-1)
        B, Tq, _ = q.shape
        H, hd = self.heads, D // self.heads
        q = q.reshape(B, Tq, H, hd)
        k = k.reshape(B, -1, H, hd)
        v = v.reshape(B, -1, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits / math.sqrt(hd)
        if mask is not None:
            logits = logits + mask.float()
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
        return self.out_proj(out.reshape(B, Tq, D).to(q.dtype))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig):
        super().__init__()
        D = cfg.dim_model
        self.self_attn = MultiheadAttention(D, cfg.num_heads)
        self.linear1 = nn.Linear(D, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, D)
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig):
        super().__init__()
        D = cfg.dim_model
        self.self_attn = MultiheadAttention(D, cfg.num_heads)
        self.multihead_attn = MultiheadAttention(D, cfg.num_heads)
        self.linear1 = nn.Linear(D, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, D)
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)
        self.norm3 = nn.LayerNorm(D, eps=1e-5)

    def forward(self, x, memory, tgt_mask):
        x = self.norm1(x + self.self_attn(x, x, tgt_mask))
        x = self.norm2(x + self.multihead_attn(x, memory))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class _Stack(nn.Module):
    def __init__(self, layers, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class _Seq2Seq(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig):
        super().__init__()
        D = cfg.dim_model
        self.encoder = _Stack([EncoderLayer(cfg)
                               for _ in range(cfg.num_encoder_layers)], D)
        self.decoder = _Stack([DecoderLayer(cfg)
                               for _ in range(cfg.num_decoder_layers)], D)


class FrameTransformer(nn.Module):
    """Seq2seq encoder-decoder over flattened frame latents, batch-first.

    ``model(src, tgt, tgt_mask)`` -> (B, T_tgt, latent_dim) f32.
    """

    def __init__(self, cfg: FrameTransformerConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim_model
        self.embedding = nn.Linear(cfg.latent_dim, D)
        self.transformer = _Seq2Seq(cfg)
        self.out = nn.Linear(D, cfg.latent_dim)
        self.register_buffer("pos_table", sinusoidal_positions(cfg.max_len, D),
                             persistent=False)

    def forward(self, src, tgt, tgt_mask=None):
        dt = self.embedding.weight.dtype
        scale = math.sqrt(self.cfg.dim_model)
        src = self.embedding(src.to(dt)) * scale
        tgt = self.embedding(tgt.to(dt)) * scale
        pe = self.pos_table.to(dt)
        if self.cfg.pe_mode == "reference_batch":
            src = src + pe[: src.shape[0]][:, None, :]
            tgt = tgt + pe[: tgt.shape[0]][:, None, :]
        else:
            src = src + pe[None, : src.shape[1]]
            tgt = tgt + pe[None, : tgt.shape[1]]

        memory = src
        for layer in self.transformer.encoder.layers:
            memory = layer(memory)
        memory = self.transformer.encoder.norm(memory)
        x = tgt
        for layer in self.transformer.decoder.layers:
            x = layer(x, memory, tgt_mask)
        x = self.transformer.decoder.norm(x)
        return self.out(x).float()
