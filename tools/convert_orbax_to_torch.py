"""Convert a JAX-package train checkpoint (an Orbax directory) into the
PyTorch port's checkpoint directory (``state.pt``).

    python tools/convert_orbax_to_torch.py --src <orbax dir> --dst <port dir> \
        --config <name> [--config_dir <dir>] [--train_mode ar] \
        [--precision f32]

The JAX package writes its train state with Orbax
(``sd_video_gen_tpu/train/checkpoint.py``), which needs JAX to read; the
port (``sd_video_gen_tpu_torch``) does not import JAX. This tool runs where
JAX is installed. It restores ``--src`` with the JAX package's own
``restore_checkpoint`` (format v2, and v1 checkpoints migrated as that
function migrates them) into the train state the JAX trainer builds for the
config, mode and precision, and writes ``--dst`` through the port's
``diffusion/weights.train_state_from_jax`` and ``train/checkpoint``:
parameters, Adam moments and step under the port's names. The port's
trainer resumes from the result (``--resume True --old_name <dst>``) and its
predict CLIs serve it. The codec does not enter the train state: a pixel
codec of the config's frame size shapes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sd_video_gen_tpu.codecs import PixelCodec  # noqa: E402
from sd_video_gen_tpu.config import load_config  # noqa: E402
from sd_video_gen_tpu.models import (FrameTransformer,  # noqa: E402
                                     FrameTransformerConfig)
from sd_video_gen_tpu.ops import LossWeights  # noqa: E402
from sd_video_gen_tpu.train import checkpoint as jckpt  # noqa: E402
from sd_video_gen_tpu.train.trainer import make_train_step  # noqa: E402
from sd_video_gen_tpu_torch.diffusion.weights import (  # noqa: E402
    train_state_from_jax)
from sd_video_gen_tpu_torch.train import checkpoint as pckpt  # noqa: E402

PRECISIONS = ("f32", "bf16", "bf16_full")


def abstract_train_state(cfg, mode: str = "ar", precision: str = "f32"):
    """The shapes and dtypes of the JAX trainer's train state for ``cfg``
    (``Trainer.init_state`` traced, nothing computed)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision}")
    mc = FrameTransformerConfig.from_config(
        cfg, mode=mode if mode in ("future", "learned_tgt", "text") else "ar")
    if precision != "f32":
        mc = dataclasses.replace(
            mc, dtype=jnp.bfloat16,
            param_dtype=(jnp.bfloat16 if precision == "bf16_full"
                         else jnp.float32))
    codec = PixelCodec(cfg.frame_size)
    init_fn, _ = make_train_step(
        FrameTransformer(mc), codec, LossWeights.from_config(cfg), cfg, mode,
        mu_dtype=jnp.bfloat16 if precision == "bf16_full" else None)
    frames = jax.ShapeDtypeStruct(
        (1, cfg.frames_per_clip + cfg.frames_to_predict, cfg.frame_size,
         cfg.frame_size, 3), jnp.uint8)
    text = (jax.ShapeDtypeStruct((1, mc.text_embed_dim), jnp.float32)
            if mode == "text" else None)
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0), frames, text)


def convert(src: str, dst: str, cfg, mode: str = "ar",
            precision: str = "f32") -> dict:
    """Restore the Orbax checkpoint ``src`` and write it as the port's
    checkpoint ``dst``; returns the port's state (``TrainState.state_dict()``
    form, CPU tensors)."""
    state = jckpt.restore_checkpoint(src, abstract_train_state(cfg, mode,
                                                               precision))
    host = jax.tree.map(np.asarray, jax.device_get(state))
    port = train_state_from_jax(host.params, host.opt_state, int(host.step))
    pckpt.save_checkpoint(dst, port)
    return port


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True, help="the JAX (Orbax) checkpoint "
                   "directory, <checkpoint_dir>/<config>_<index>_<mode>")
    p.add_argument("--dst", required=True, help="the port's checkpoint "
                   "directory to write")
    p.add_argument("--config", required=True)
    p.add_argument("--config_dir", default=None)
    p.add_argument("--train_mode", default="ar",
                   choices=["ar", "future", "diff", "text", "learned_tgt"])
    p.add_argument("--precision", default="f32", choices=PRECISIONS)
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.config_dir)
    state = convert(args.src, args.dst, cfg, args.train_mode, args.precision)
    n = sum(v.numel() for v in state["params"].values())
    print(f"converted {args.src} (format v{jckpt.read_format_version(args.src)}"
          f", step {state['step']}, {n} parameters) -> {args.dst}")


if __name__ == "__main__":
    main()
