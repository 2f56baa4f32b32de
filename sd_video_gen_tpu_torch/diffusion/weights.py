"""Bridge: JAX-package parameter trees -> the port's ``state_dict``s.

The JAX package's models (``sd_video_gen_tpu/models``) hold flax param trees;
given one as nested dicts of numpy arrays, the functions here return the
state_dict of the port's counterpart module, whose names follow the diffusers
/ transformers / reference-torch checkpoint keys. Layouts:

  flax Conv kernel  (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)
  flax Dense kernel (I, O)         -> torch Linear weight (O, I)
  flax scale / embedding           -> weight

Fused weights: the JAX UNet keeps GEGLU as two projections (``geglu_proj_h``
and ``geglu_proj_gate``), the port one ``ff.net.0.proj`` (h rows first); the
JAX transformer splits its cross-attention into q/k/v, the port keeps
``multihead_attn.in_proj_weight`` (q, k, v rows).

``load_jax_params`` checks exhaustiveness both ways: every JAX leaf is used
exactly once, and every port parameter is assigned with its shape.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_COMMON = [
    (r"/to_out_0/", "/to_out/0/"),
]

_RULES = {
    "vae": [
        (r"^encoder/down_(\d+)_res_(\d+)/", r"encoder/down_blocks/\1/resnets/\2/"),
        (r"^encoder/down_(\d+)_downsample/",
         r"encoder/down_blocks/\1/downsamplers/0/"),
        (r"^decoder/up_(\d+)_res_(\d+)/", r"decoder/up_blocks/\1/resnets/\2/"),
        (r"^decoder/up_(\d+)_upsample/", r"decoder/up_blocks/\1/upsamplers/0/"),
        (r"/mid/resnet_(\d+)/", r"/mid_block/resnets/\1/"),
        (r"/mid/attn/", "/mid_block/attentions/0/"),
        (r"^(encoder|decoder)/norm_out/", r"\1/conv_norm_out/"),
    ],
    "unet": [
        (r"^norm_out/", "conv_norm_out/"),
        (r"^(down|up)_(\d+)_res_(\d+)/", r"\1_blocks/\2/resnets/\3/"),
        (r"^(down|up)_(\d+)_attn_(\d+)/", r"\1_blocks/\2/attentions/\3/"),
        (r"^down_(\d+)_downsample/", r"down_blocks/\1/downsamplers/0/"),
        (r"^up_(\d+)_upsample/", r"up_blocks/\1/upsamplers/0/"),
        (r"^mid_res_(\d+)/", r"mid_block/resnets/\1/"),
        (r"^mid_attn/", "mid_block/attentions/0/"),
        (r"/block_0/", "/transformer_blocks/0/"),
        (r"/ff/geglu_proj_h/(\w+)$", r"/ff/net/0/proj/\1#0"),
        (r"/ff/geglu_proj_gate/(\w+)$", r"/ff/net/0/proj/\1#1"),
        (r"/ff/out_proj/", "/ff/net/2/"),
    ],
    "clip": [
        (r"^token_embedding/", "embeddings/token_embedding/"),
        (r"^position_embedding$", "embeddings/position_embedding/weight"),
        (r"^layer_(\d+)/", r"encoder/layers/\1/"),
        (r"/(fc1|fc2)/", r"/mlp/\1/"),
    ],
    "transformer": [
        (r"^enc_(\d+)/", r"transformer/encoder/layers/\1/"),
        (r"^dec_(\d+)/", r"transformer/decoder/layers/\1/"),
        (r"^enc_norm/", "transformer/encoder/norm/"),
        (r"^dec_norm/", "transformer/decoder/norm/"),
        (r"/self_attn/qkv/(\w+)$", r"/self_attn/in_proj_\1"),
        (r"/cross_attn/q/(\w+)$", r"/multihead_attn/in_proj_\1#0"),
        (r"/cross_attn/k/(\w+)$", r"/multihead_attn/in_proj_\1#1"),
        (r"/cross_attn/v/(\w+)$", r"/multihead_attn/in_proj_\1#2"),
        (r"/(self_attn|cross_attn)/out/", r"/\1/out_proj/"),
        (r"/cross_attn/out_proj/", "/multihead_attn/out_proj/"),
        (r"/ffn/lin(\d)/", r"/linear\1/"),
    ],
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _to_torch_layout(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 4:                      # HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:                      # (in, out) -> (out, in)
            return "weight", arr.T
        raise ValueError(f"unexpected {arr.ndim}-d kernel")
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def bridge_state_dict(kind: str, jax_params: dict) -> dict[str, np.ndarray]:
    """Flax param tree of model ``kind`` ('vae', 'unet', 'clip',
    'transformer') -> the port's state_dict as numpy arrays."""
    if kind not in _RULES:
        raise ValueError(f"unknown model kind {kind!r}")
    tree = jax_params.get("params", jax_params)
    parts: dict[str, dict[int, np.ndarray]] = {}
    for path, arr in _leaves(tree):
        name, arr = _to_torch_layout(path[-1], arr)
        key = "/".join(path[:-1] + (name,))
        for pat, rep in _COMMON + _RULES[kind]:
            key = re.sub(pat, rep, key)
        key, _, part = key.partition("#")
        key = key.replace("/", ".")
        slot = parts.setdefault(key, {})
        idx = int(part) if part else 0
        if idx in slot:
            raise ValueError(f"bridge_{kind}: two JAX leaves map to {key}")
        slot[idx] = arr
    out = {}
    for key, slot in parts.items():
        if sorted(slot) != list(range(len(slot))):
            raise ValueError(f"bridge_{kind}: {key} is missing fused parts "
                             f"(have {sorted(slot)})")
        out[key] = (np.concatenate([slot[i] for i in range(len(slot))], 0)
                    if len(slot) > 1 else slot[0])
    return out


def vae_state_dict(jax_params):
    return bridge_state_dict("vae", jax_params)


def unet_state_dict(jax_params):
    return bridge_state_dict("unet", jax_params)


def clip_text_state_dict(jax_params):
    return bridge_state_dict("clip", jax_params)


def frame_transformer_state_dict(jax_params):
    return bridge_state_dict("transformer", jax_params)


def load_jax_params(module: torch.nn.Module, kind: str, jax_params):
    """Assign a JAX param tree to ``module`` after proving the two agree:
    no port parameter left unassigned, no JAX leaf unused, every shape equal.
    Values are cast to each parameter's dtype and device."""
    sd = bridge_state_dict(kind, jax_params)
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    bad = sorted(k for k in set(sd) & set(want)
                 if tuple(sd[k].shape) != tuple(want[k].shape))
    if missing or extra or bad:
        raise ValueError(
            f"bridge_{kind}: {len(missing)} port params unassigned "
            f"{missing[:10]}; {len(extra)} JAX leaves unused {extra[:10]}; "
            "shape mismatches " + "; ".join(
                f"{k}: {tuple(sd[k].shape)} vs {tuple(want[k].shape)}"
                for k in bad[:10]))
    module.load_state_dict({
        k: torch.from_numpy(np.array(v)).to(
            dtype=want[k].dtype, device=want[k].device)
        for k, v in sd.items()}, strict=True)
    return module
