"""The frame-latent seq2seq transformer (mode 'ar'), plain and float32.

torch ``nn.Transformer`` semantics as the reference repository uses them:
post-LN, ReLU feed-forward, a final LayerNorm after each stack, inputs
embedded by a Linear times sqrt(D) plus the sinusoidal table; dropout on
the embedded inputs, the attention weights, after the ReLU and on every
residual branch. Parameter names are the reference's ``nn.Transformer``
state_dict names.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Dropout


@dataclasses.dataclass(frozen=True)
class FrameTransformerConfig:
    latent_dim: int
    dim_model: int = 2048
    num_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 8
    dropout_p: float = 0.1
    dim_feedforward: int = 2048
    max_len: int = 64


def sinusoidal_positions(max_len: int, dim: int) -> torch.Tensor:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    table = np.zeros((max_len, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: table[:, 1::2].shape[1]])
    return torch.from_numpy(table)


class MultiheadAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, drop, mask=None):
        D = self.in_proj_weight.shape[0] // 3
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(q_in, w[:D], b[:D])
        k = F.linear(kv_in, w[D:2 * D], b[D:2 * D])
        v = F.linear(kv_in, w[2 * D:], b[2 * D:])
        B, Tq, _ = q.shape
        H, hd = self.heads, D // self.heads
        q, k, v = (t.reshape(B, -1, H, hd) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if mask is not None:
            logits = logits + mask
        weights = drop(torch.softmax(logits, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Tq, D)
        return self.out_proj(out)


def _ffn(layer, x, drop):
    return layer.linear2(drop(F.relu(layer.linear1(x))))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: FrameTransformerConfig):
        super().__init__()
        D = cfg.dim_model
        self.self_attn = MultiheadAttention(D, cfg.num_heads)
        self.linear1 = nn.Linear(D, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, D)
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)

    def forward(self, x, drop):
        x = self.norm1(x + drop(self.self_attn(x, x, drop)))
        return self.norm2(x + drop(_ffn(self, x, drop)))


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

    def forward(self, x, memory, mask, drop):
        x = self.norm1(x + drop(self.self_attn(x, x, drop, mask)))
        x = self.norm2(x + drop(self.multihead_attn(x, memory, drop)))
        return self.norm3(x + drop(_ffn(self, x, drop)))


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
    """``model(src, tgt, mask, generator)`` -> (B, T_tgt, latent_dim); with
    a generator, dropout at ``cfg.dropout_p`` drawn from it."""

    def __init__(self, cfg: FrameTransformerConfig):
        super().__init__()
        self.cfg = cfg
        D, L = cfg.dim_model, cfg.latent_dim
        self.embedding = nn.Linear(L, D)
        self.transformer = _Seq2Seq(cfg)
        self.out = nn.Linear(D, L)
        self.register_buffer("pos_table", sinusoidal_positions(cfg.max_len, D),
                             persistent=False)

    def forward(self, src, tgt, mask=None, generator=None):
        drop = Dropout(self.cfg.dropout_p, generator)
        scale = math.sqrt(self.cfg.dim_model)
        pe = self.pos_table.to(src.device)
        src = self.embedding(src) * scale + pe[None, : src.shape[1]]
        tgt = self.embedding(tgt) * scale + pe[None, : tgt.shape[1]]
        src, tgt = drop(src), drop(tgt)
        memory = src
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, drop)
        memory = self.transformer.encoder.norm(memory)
        x = tgt
        for layer in self.transformer.decoder.layers:
            x = layer(x, memory, mask, drop)
        return self.out(self.transformer.decoder.norm(x))
