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
``multihead_attn.in_proj_weight`` (q, k, v rows). The transformer's mode
parameters keep the reference's names: ``learned_tgt``, ``query_pos``,
``project_image_embedding``, and ``tgt_norm`` -> ``norm``.

``load_jax_params`` checks exhaustiveness both ways: every JAX leaf is used
exactly once, and every port parameter is assigned with its shape.

``train_state_from_jax`` takes a JAX ``TrainState``'s parameters, Adam
moments and step through the same map into the port's train state, so that
one JAX step and one port step can start from the same state.

``quantized_tree_from_jax`` turns the JAX package's int8 serving trees
(``quantize_frame_transformer``, ``quantize_rollout_params``) into the port's
(``ops/quantized.py``), value for value. ``i3d_state_dict`` turns the JAX
I3D's tree into the ``pytorch_i3d`` layout ``models/i3d.py`` loads.

Weight files (``load_state_dict``, ``convert_exhaustive``, ``load_weights``):
a ``.safetensors`` or ``.pt`` file of diffusers / transformers / reference
keys loads into the port's ``AutoencoderKL``, ``UNet2DCondition``,
``CLIPTextEncoder`` and ``FrameTransformer``, exhaustively both ways: a file
key that is never read, a parameter left unfilled and a shape that differs
each raise. The port's names are the files' own, except where the layouts
differ: the VAE's attention keys of both diffusers vintages
(``query/key/value/proj_attn`` and ``to_q/to_k/to_v/to_out.0``; CompVis-era
1x1 convolutions there are squeezed to Linear weights), the
``text_model.`` prefix of a CLIP text encoder, and the positional buffer of
a reference FrameTransformer ``.pt`` (and the frozen sentence encoder of its
text mode), which the port does not keep. ``position_ids`` and
``num_batches_tracked`` are ignored.
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
        (r"^tgt_norm/", "norm/"),
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


def train_state_from_jax(params, opt_state, step) -> dict:
    """A JAX train state -> the port's (``TrainState.state_dict()`` form:
    ``{"step", "params", "mu", "nu"}``, CPU tensors under the port's
    parameter names; ``TrainState.load_state_dict`` takes it).

    ``params`` is the FrameTransformer's flax tree; ``opt_state`` the optax
    Adam state (a tuple whose first member has ``mu`` and ``nu`` trees shaped
    like ``params``), leaves as numpy arrays or anything ``np.asarray``
    takes. The moments go through the same name and layout map as the
    parameters (transposes, fused ``in_proj`` rows): it only permutes and
    concatenates, so it commutes with Adam's element-wise arithmetic.
    bf16 leaves stay bf16."""
    adam = next((s for s in (opt_state if isinstance(opt_state, (tuple, list))
                             else (opt_state,))
                 if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("train_state_from_jax: no Adam state (mu, nu) in "
                         "opt_state")

    def tensors(tree):
        out = {}
        for k, a in bridge_state_dict("transformer", tree).items():
            if a.dtype.name == "bfloat16":     # numpy has no native bf16
                out[k] = torch.from_numpy(
                    np.array(a.astype(np.float32))).to(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(np.array(a))
        return out

    return {"step": int(step), "params": tensors(params),
            "mu": tensors(adam.mu), "nu": tensors(adam.nu)}


def _is_qtensor(node) -> bool:
    return (not isinstance(node, dict) and hasattr(node, "values")
            and hasattr(node, "scale"))


def quantized_tree_from_jax(jax_tree: dict, device="cpu",
                            dtype=torch.float32) -> dict:
    """The JAX package's int8 tree of a FrameTransformer (mode 'ar') -> the
    port's (``ops/quantized.py``), with the same int8 values and scales.

    Takes either layout: ``quantize_frame_transformer``'s (``enc`` / ``dec``
    lists) or ``quantize_rollout_params``'s (the flax tree, ``enc_0`` ...
    under ``params``), with numpy or JAX arrays as leaves. ``dtype`` is the
    compute dtype the tree serves at (``cached_rollout``). Biases and norms
    are taken as f32. Every JAX entry must be used."""
    from sd_video_gen_tpu_torch.ops.quantized import QTensor
    tree = dict(jax_tree.get("params", jax_tree))
    for side in ("enc", "dec"):
        if side not in tree:
            tree[side] = []
            while f"{side}_{len(tree[side])}" in tree:
                tree[side].append(tree.pop(f"{side}_{len(tree[side])}"))
    ten = lambda a: torch.from_numpy(np.array(a)).to(device)

    def dense(*parts):
        """One or more JAX {q: QTensor, bias} fused along the outputs."""
        if not all(set(p) == {"q", "bias"} and _is_qtensor(p["q"])
                   for p in parts):
            raise ValueError("quantized_tree_from_jax: expected {q, bias}, "
                             f"got {[sorted(p) for p in parts]}")
        values = np.concatenate([np.asarray(p["q"].values) for p in parts], 1)
        scale = np.concatenate([np.asarray(p["q"].scale) for p in parts])
        bias = np.concatenate([np.asarray(p["bias"]) for p in parts])
        # (in, out) values over the (out, in) weight's own memory
        return {"q": QTensor(ten(values.T).contiguous().t(), ten(scale)),
                "bias": ten(bias)}

    norm = lambda n: {"weight": ten(n["scale"]), "bias": ten(n["bias"])}

    def layer(l, decoder):
        ffn = l.get("ffn", l)
        want = {"self_attn", "ffn", "norm1", "norm2"}
        out = {"self_attn": {"qkv": dense(l["self_attn"]["qkv"]),
                             "out": dense(l["self_attn"]["out"])},
               "lin1": dense(ffn["lin1"]), "lin2": dense(ffn["lin2"]),
               "norm1": norm(l["norm1"]), "norm2": norm(l["norm2"])}
        if decoder:
            c = l["cross_attn"]
            out["cross_attn"] = {"q": dense(c["q"]),
                                 "kv": dense(c["k"], c["v"]),
                                 "out": dense(c["out"])}
            out["norm3"] = norm(l["norm3"])
            want |= {"cross_attn", "norm3"}
        if set(l) != want:
            raise ValueError(f"quantized_tree_from_jax: layer keys "
                             f"{sorted(l)}, expected {sorted(want)}")
        return out

    want = {"embedding", "out", "enc_norm", "dec_norm", "enc", "dec"}
    if set(tree) != want:
        raise ValueError(f"quantized_tree_from_jax: keys {sorted(tree)}, "
                         f"expected {sorted(want)}")
    return {"dtype": dtype, "embedding": dense(tree["embedding"]),
            "out": dense(tree["out"]), "enc_norm": norm(tree["enc_norm"]),
            "dec_norm": norm(tree["dec_norm"]),
            "enc": [layer(l, False) for l in tree["enc"]],
            "dec": [layer(l, True) for l in tree["dec"]]}


def i3d_state_dict(jax_params) -> dict[str, np.ndarray]:
    """The JAX package's I3D param tree -> the ``pytorch_i3d`` state dict
    (``models/i3d.py`` names): conv kernels (kd, kh, kw, I, O) -> (O, I, kd,
    kh, kw), ``bn_scale/bn_bias/bn_mean/bn_var`` -> ``bn.weight/bias/
    running_mean/running_var``."""
    tree = jax_params.get("params", jax_params)
    out = {}
    bn = (("bn_scale", "weight"), ("bn_bias", "bias"),
          ("bn_mean", "running_mean"), ("bn_var", "running_var"))

    def unit(prefix, p):
        out[prefix + ".conv3d.weight"] = np.asarray(
            p["conv3d"]["kernel"]).transpose(4, 3, 0, 1, 2)
        if "bias" in p["conv3d"]:
            out[prefix + ".conv3d.bias"] = np.asarray(p["conv3d"]["bias"])
        for jname, tname in bn:
            if jname in p:
                out[f"{prefix}.bn.{tname}"] = np.asarray(p[jname])

    for name, p in tree.items():
        if name.startswith("Mixed_"):
            for branch, q in p.items():
                unit(f"{name}.{branch}", q)
        else:
            unit(name, p)
    return out


# -- weight files -------------------------------------------------------------

# checkpoint entries that are buffers or bookkeeping, not parameters
_IGNORED_KEY_PARTS = ("position_ids", "num_batches_tracked")
_VAE_ATTN = re.compile(r"^((?:encoder|decoder)\.mid_block\.attentions\.\d+)\."
                       r"(to_q|to_k|to_v|to_out\.0|q|k|v|proj_out|norm)\."
                       r"(weight|bias)$")
_VAE_ATTN_NAMES = {"to_q": "query", "q": "query", "to_k": "key", "k": "key",
                   "to_v": "value", "v": "value", "to_out.0": "proj_attn",
                   "proj_out": "proj_attn", "norm": "group_norm"}
KINDS = ("vae", "unet", "clip", "transformer")


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A checkpoint file -> {name: CPU tensor} in the file's dtypes:
    ``.safetensors``, or a ``torch.save`` file (``.pt`` / ``.bin``), bare or
    under a ``"state_dict"`` key."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path, device="cpu")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _file_key(kind: str, key: str, text_mode: bool):
    """A file key -> the port's name, or None for an entry the port does
    not keep."""
    if any(part in key for part in _IGNORED_KEY_PARTS):
        return None
    if kind == "vae":
        m = _VAE_ATTN.match(key)
        if m:
            return f"{m[1]}.{_VAE_ATTN_NAMES[m[2]]}.{m[3]}"
    elif kind == "clip":
        return key.removeprefix("text_model.")
    elif kind == "transformer":
        # the positional table is a buffer the port generates; text mode's
        # frozen sentence encoder is replaced by the embedding table
        if "positional_encoder" in key or (
                text_mode and key.startswith("sent_transformer.")):
            return None
    return key


def convert_exhaustive(kind: str, sd: dict, module: torch.nn.Module) -> dict:
    """A weight file's state dict -> ``module``'s, proved exhaustive both
    ways: every file key is read (ignored bookkeeping aside), every
    parameter is filled, every shape agrees; otherwise ``ValueError``
    listing what differs. 1x1 convolution weights are squeezed where the
    module holds a Linear. Values keep the file's dtype."""
    if kind not in KINDS:
        raise ValueError(f"unknown model kind {kind!r}")
    want = module.state_dict()
    text_mode = getattr(getattr(module, "cfg", None), "mode", None) == "text"
    out: dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        name = _file_key(kind, key, text_mode)
        if name is None:
            continue
        if name in out:
            raise ValueError(f"convert_{kind}: two file keys map to {name}")
        v = torch.as_tensor(v)
        if (v.ndim == 4 and name in want and want[name].ndim == 2
                and tuple(v.shape[2:]) == (1, 1)):
            v = v[:, :, 0, 0]
        out[name] = v
    unread = sorted(set(out) - set(want))
    missing = sorted(set(want) - set(out))
    bad = sorted(k for k in set(out) & set(want)
                 if tuple(out[k].shape) != tuple(want[k].shape))
    if unread or missing or bad:
        raise ValueError(
            f"convert_{kind}: {len(unread)} file keys never consumed "
            f"(first 20) {unread[:20]}; {len(missing)} parameters missing "
            f"from the file (first 20) {missing[:20]}; shape mismatches "
            + "; ".join(f"{k}: file {tuple(out[k].shape)} vs model "
                        f"{tuple(want[k].shape)}" for k in bad[:10]))
    return out


def load_weights(module: torch.nn.Module, kind: str, source):
    """Fill ``module`` from a weight file (a path, or a state dict already
    loaded) through ``convert_exhaustive``; values are cast to each
    parameter's dtype and device, memory formats kept."""
    sd = load_state_dict(source) if isinstance(source, str) else source
    with torch.no_grad():
        module.load_state_dict(convert_exhaustive(kind, sd, module),
                               strict=True)
    return module


def build_from_file(module_cls, cfg, kind: str, path, device=None,
                    dtype=torch.float32, seed: int = 0, shard=None):
    """``models.build(module_cls, cfg, device, dtype, seed)`` filled from
    the weight file at ``path`` through ``load_weights``; with ``path=None``
    the seeded random weights stay. With ``shard`` (a tensor-parallel rank,
    ``parallel/mesh.ModelShard``), that rank's slice of the filled model
    (``models.shard_module``)."""
    from sd_video_gen_tpu_torch.models import build, shard_module
    module = build(module_cls, cfg, device, dtype, seed)
    if path:
        load_weights(module, kind, path)
    if shard is not None and shard.size > 1:
        return shard_module(module, shard)
    return module
