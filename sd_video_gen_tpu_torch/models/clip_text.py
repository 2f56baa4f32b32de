"""CLIP ViT-L/14 text encoder in PyTorch (conditioning for the SD UNet).

Counterpart of ``sd_video_gen_tpu/models/clip_text.py``: pre-LN transformer,
quick-GELU MLPs, causal mask, final LayerNorm. Parameter names follow the
transformers ``CLIPTextModel`` keys without the ``text_model.`` prefix
(``embeddings.token_embedding.weight``, ``encoder.layers.0.self_attn.q_proj
.weight``, ``final_layer_norm.weight``). The video denoise path only embeds
the empty prompt, so ``empty_prompt_ids`` gives its token ids without
tokenizer files.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sd_video_gen_tpu_torch.ops.masks import causal_mask

BOS_TOKEN = 49406
EOS_TOKEN = 49407


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    layer_norm_eps: float = 1e-5


def empty_prompt_ids(batch: int = 1, max_length: int = 77,
                     device=None) -> torch.Tensor:
    """Token ids of '' under the SD CLIP tokenizer: [BOS, EOS, EOS, ...]."""
    ids = torch.full((batch, max_length), EOS_TOKEN, dtype=torch.long,
                     device=device)
    ids[:, 0] = BOS_TOKEN
    return ids


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


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
        q = self.q_proj(x).reshape(B, T, H, hd)
        k = self.k_proj(x).reshape(B, T, H, hd)
        v = self.v_proj(x).reshape(B, T, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        w = torch.softmax(logits * hd ** -0.5 + mask, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(x.dtype)
        return self.out_proj(o.reshape(B, T, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
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
    """(B, T) int token ids -> (B, T, hidden) last hidden state, f32."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        mask = causal_mask(input_ids.shape[1], device=x.device)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x).float()
