"""The CLIP ViT-L/14 text encoder, plain: pre-LN, quick-GELU MLPs, causal
mask, final LayerNorm; the transformers ``CLIPTextModel`` keys without the
``text_model.`` prefix. The refiner embeds only the empty prompt."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from benchmark.reference.layers import causal_mask

BOS_TOKEN, EOS_TOKEN = 49406, 49407


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    layer_norm_eps: float = 1e-5


def empty_prompt_ids(batch: int, max_length: int, device=None):
    """'' under the SD CLIP tokenizer: [BOS, EOS, EOS, ...]."""
    ids = torch.full((batch, max_length), EOS_TOKEN, dtype=torch.long,
                     device=device)
    ids[:, 0] = BOS_TOKEN
    return ids


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x, mask):
        B, T, D = x.shape
        H, hd = self.heads, D // self.heads
        q, k, v = (p(x).reshape(B, T, H, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5 + mask
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
        return self.out_proj(o.reshape(B, T, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)

    def forward(self, ids):
        return (self.token_embedding(ids)
                + self.position_embedding.weight[None, : ids.shape[1]])


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, ids):
        x = self.embeddings(ids)
        mask = causal_mask(ids.shape[1], device=x.device)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)
