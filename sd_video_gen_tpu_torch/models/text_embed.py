"""Class-name text embeddings as a lookup table on the device
(``sd_video_gen_tpu/models/text_embed.py``).

The conditioning set is a fixed vocabulary (<= 101 UCF class names), so the
embedding of each class name is computed once and the (num_classes, dim)
table lives on the device; a request gathers rows by label id. Tables can be

  - loaded from an ``.npy`` of exported MiniLM embeddings (``from_npy``), or
  - derived from the class-name strings (hash-seeded unit gaussians), so the
    text pipeline runs without MiniLM weights.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from sd_video_gen_tpu_torch.models import default_device


def _name_embedding(name: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def split_class_name(name: str) -> str:
    """'WallPushups' -> 'Wall Pushups': CamelCase directory names become
    prompts."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and not name[i - 1].isupper():
            out.append(" ")
        out.append(ch)
    return "".join(out)


class ClassNameEmbedder:
    """``embedder(labels (B,) ints) -> (B, dim) f32`` on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, num_classes: int, dim: int = 384,
                 table: np.ndarray | None = None,
                 names: list[str] | None = None, device=None):
        if table is not None:
            if table.shape[1] != dim:
                raise ValueError(f"table is {table.shape[1]} wide, dim={dim}")
            table = np.asarray(table, np.float32)
        elif names is not None:
            table = np.stack([_name_embedding(split_class_name(n), dim)
                              for n in names])
        else:
            table = np.stack([_name_embedding(f"class_{i}", dim)
                              for i in range(num_classes)])
        self.table = torch.from_numpy(table).to(default_device(device))
        self.dim = dim

    @classmethod
    def from_npy(cls, path: str, device=None) -> "ClassNameEmbedder":
        t = np.load(path)
        return cls(t.shape[0], t.shape[1], table=t, device=device)

    def __call__(self, labels) -> torch.Tensor:
        """Ids are bounds-checked on the host before any gather: an id past
        the table must not condition on some other class's row."""
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy()
        ids = np.asarray(labels, np.int64)
        n = self.table.shape[0]
        if ids.size and (ids.max() >= n or ids.min() < 0):
            raise IndexError(
                f"class id out of range for {n}-row text-embedding table")
        return self.table[torch.from_numpy(ids).to(self.table.device)]
