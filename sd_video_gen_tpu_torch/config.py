"""Config system: reference-compatible YAML schema + CLI, threaded as one immutable object
(``sd_video_gen_tpu/config.py``; the port keeps its own copy).

The reference (utils/config.py:8-49) loads YAML files whose UPPERCASE keys map to
1-element lists (sweep grid values; FRAME_SIZE is a bare scalar), and re-invokes a
global argparse inside model constructors and dataset classes. This rebuild keeps the
YAML key schema and CLI flags verbatim, but parses them ONCE into a frozen
``Config`` dataclass that is passed explicitly everywhere (no hidden CLI state).

``yaml`` is imported inside ``load_raw_config``: a ``Config`` built directly
(as ``chip_smoke.py`` does) needs no YAML reader installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import warnings
from typing import Any, Sequence


def _first(v):
    """YAML values are 1-element lists feeding the sweep grid; scalars pass through."""
    if isinstance(v, (list, tuple)):
        return v[0]
    return v


def _aslist(v) -> list:
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


@dataclasses.dataclass(frozen=True)
class Config:
    """One immutable hyperparameter set (a single point of the sweep grid).

    Field names mirror the reference YAML keys (config/11_27_ucf_final.yml) in
    lowercase. ``latent_dim`` etc. are derived properties.
    """

    config_name: str = "config_test"

    # General
    lr: float = 1e-5
    batch_size: int = 6
    epochs: int = 100
    epoch_ratio: float = 1.0
    num_workers: int = 0

    # Video
    frames_per_clip: int = 5
    frames_to_predict: int = 5
    stride: int = 1
    fps: int = 3
    frame_size: int = 128

    # Transformer
    dim_model: int = 2048
    num_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 8
    dropout_p: float = 0.1

    # Losses
    use_mse: bool = True
    use_l1: bool = False
    use_gdl: bool = True
    lambda_gdl: float = 1.0
    alpha: float = 1.0
    use_contrastive: bool = True
    lambda_contrastive: float = 0.025
    temperature: float = 0.07

    # --- derived ---
    @property
    def latent_hw(self) -> int:
        """Spatial side of the SD latent (VAE downsamples 8x)."""
        return self.frame_size // 8

    @property
    def latent_dim(self) -> int:
        """Flattened frame-latent token dim: 4 * (H/8) * (W/8).

        Matches the reference embedding input (models/transformer.py:37).
        """
        return 4 * self.latent_hw * self.latent_hw

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Mapping YAML key -> Config field.
_YAML_KEYS = {
    "LR": "lr",
    "BATCH_SIZE": "batch_size",
    "EPOCHS": "epochs",
    "EPOCH_RATIO": "epoch_ratio",
    "NUM_WORKERS": "num_workers",
    "FRAMES_PER_CLIP": "frames_per_clip",
    "FRAMES_TO_PREDICT": "frames_to_predict",
    "STRIDE": "stride",
    "FPS": "fps",
    "FRAME_SIZE": "frame_size",
    "DIM_MODEL": "dim_model",
    "NUM_HEADS": "num_heads",
    "NUM_ENCODER_LAYERS": "num_encoder_layers",
    "NUM_DECODER_LAYERS": "num_decoder_layers",
    "DROPOUT_P": "dropout_p",
    "USE_MSE": "use_mse",
    "USE_L1": "use_l1",
    "USE_GDL": "use_gdl",
    "LAMBDA_GDL": "lambda_gdl",
    "ALPHA": "alpha",
    "USE_CONTRASTIVE": "use_contrastive",
    "LAMBDA_CONTRASTIVE": "lambda_contrastive",
    "TEMPERATURE": "temperature",
}


def _find_config_path(config_name: str, config_dir: str | None) -> str:
    candidates = []
    if config_dir:
        candidates.append(os.path.join(config_dir, config_name + ".yml"))
    candidates += [
        os.path.join("./configs", config_name + ".yml"),
        os.path.join("./config", config_name + ".yml"),
        os.path.join(os.path.dirname(__file__), "..", "configs", config_name + ".yml"),
    ]
    for p in candidates:
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"config '{config_name}' not found in {candidates}")


def load_raw_config(config_name: str, config_dir: str | None = None) -> dict:
    """Load the raw YAML dict (values kept as lists — the sweep grid).

    Keys outside the reference schema (utils/config.py uses UPPERCASE names)
    warn loudly: silently ignoring them means e.g. a lowercase ``dim_model:``
    falls back to the 2048-wide flagship default and the user trains a 437M
    model without asking for it.

    Where PyYAML is not installed, the file is read as JSON, YAML's flow
    subset (``chip_smoke.py`` writes its config so).
    """
    with open(_find_config_path(config_name, config_dir)) as f:
        text = f.read()
    try:
        import yaml
    except ModuleNotFoundError:
        data = json.loads(text)
    else:
        data = yaml.safe_load(text)
    data = data or {}  # empty / comment-only file parses to None
    unknown = [k for k in data if k not in _YAML_KEYS]
    if unknown:
        hint = ""
        lowered = [k for k in unknown if k.upper() in _YAML_KEYS]
        if lowered:
            hint = (f" (did you mean {', '.join(k.upper() for k in lowered)}?"
                    " — the reference schema is UPPERCASE)")
        warnings.warn(
            f"config '{config_name}': ignoring unrecognized keys "
            f"{unknown}{hint}; unmatched fields keep their defaults",
            stacklevel=2)
    return data


def load_config(config_name: str, config_dir: str | None = None, **overrides) -> Config:
    """Load a YAML config into a frozen Config, taking the first grid value of each key.

    Reference semantics: utils/config.py:8-18 (SimpleNamespace of lists) +
    trainers/trainer.py:332-355 (first/swept value extraction via wandb grid).
    """
    data = load_raw_config(config_name, config_dir)
    kw: dict[str, Any] = {"config_name": config_name}
    for yk, field in _YAML_KEYS.items():
        if yk in data:
            kw[field] = _first(data[yk])
    kw.update(overrides)
    return Config(**kw)


def sweep_grid(config_name: str, config_dir: str | None = None) -> list[Config]:
    """Expand the YAML list-values into the full grid of Configs.

    Replaces the reference's W&B grid sweep (trainers/trainer.py:486-563) with a
    deterministic local product.
    """
    data = load_raw_config(config_name, config_dir)
    keys = [k for k in _YAML_KEYS if k in data]
    value_lists = [_aslist(data[k]) for k in keys]
    out = []
    for combo in itertools.product(*value_lists):
        kw = {"config_name": config_name}
        kw.update({_YAML_KEYS[k]: v for k, v in zip(keys, combo)})
        out.append(Config(**kw))
    return out


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() not in ("false", "0", "no", "none", "")


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flags, verbatim from the reference (utils/config.py:27-47).

    The reference used ``type=bool`` (any non-empty string is True); we accept the
    same invocations (``--save_best True``) but parse False correctly.
    """
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--save_best", type=_str2bool, default=False)
    p.add_argument("--folder", type=str, default=None)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--resume", type=_str2bool, default=False)
    p.add_argument("--debug", type=_str2bool, default=False)
    p.add_argument("--flip", type=_str2bool, default=False)

    p.add_argument("--pred_frames", type=int, default=1)
    p.add_argument("--show", type=_str2bool, default=False)
    p.add_argument("--old_name", type=str, default="old_name_default")
    p.add_argument("--fullscreen", type=_str2bool, default=False)
    p.add_argument("--save_output", type=_str2bool, default=False)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--denoise", type=_str2bool, default=False)
    p.add_argument("--mode", type=str, default="")
    p.add_argument("--denoise_start_step", type=int, default=40)

    # New (rebuild-only) flags; all optional, defaults preserve reference behavior.
    # Weight files replace the reference's runtime HuggingFace downloads
    # (utils/sd_utils.py:52-66) — pass local .safetensors/.bin checkpoints.
    p.add_argument("--vae_weights", type=str, default=None)
    p.add_argument("--unet_weights", type=str, default=None)
    p.add_argument("--clip_weights", type=str, default=None)
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--config_dir", type=str, default=None)
    p.add_argument("--ucf_labels", type=str,
                   default="data/UCF101TrainTestSplits-RecognitionTask/"
                           "ucfTrainTestlist",
                   help="UCF train/test split list dir (reference hardcoded "
                        "this path — trainers/trainer.py:387)")
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--torch_checkpoint", type=str, default=None,
                   help="a reference-trained .pt state_dict "
                        "(trainers/trainer.py:472) to convert and serve "
                        "instead of a checkpoint directory; .pt files matching "
                        "the reference naming in --checkpoint_dir are also "
                        "picked up automatically")
    p.add_argument("--denoise_precision", type=str, default="bf16",
                   choices=["bf16", "f32"],
                   help="compute dtype for the --denoise SD pipeline. bf16 "
                        "is the default (the tensor cores' wide format, "
                        "half the weight bandwidth); f32 reproduces the "
                        "reference's serving numerics (utils/sd_utils.py "
                        "loads fp32) bit-closer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh spec, e.g. 'data=8' or 'data=4,model=2'")
    return p


def add_multihost_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags that join a run of one process per device
    (``parallel/multihost.initialize``), shared by the trainer and the
    predict and FVD CLIs."""
    p.add_argument("--multihost", action="store_true",
                   help="join a run of one process per device "
                        "(torch.distributed: NCCL on the card, gloo on the "
                        "CPU); --mesh lays the processes out")
    p.add_argument("--coordinator", type=str, default=None,
                   help="rank 0's host:port (torchrun's MASTER_ADDR / "
                        "MASTER_PORT where absent)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def strict_f32() -> None:
    """The port's one TF32 setting: off. Every f32 matrix product and
    convolution runs in full f32 (PyTorch's default runs cuDNN convolutions
    in TF32), as the JAX package computes them and as every card number was
    measured. Each entry point that can reach the card calls this first.
    K1's f32 body splits its operands itself and does not read these
    flags; bf16 work is unaffected."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _yml_value(v) -> str:
    """YAML 1.1 reads 1e-05 as a string: floats in exponent form need a
    mantissa with a point (1.0e-05) for both JSON and PyYAML."""
    if isinstance(v, list):
        return "[" + ", ".join(_yml_value(x) for x in v) + "]"
    if isinstance(v, float) and "e" in repr(v):
        return f"{v:.1e}"
    return json.dumps(v)


def write_config(path: str, values: dict) -> None:
    """A config file in JSON, YAML's flow subset, so that
    ``load_raw_config`` reads it with or without PyYAML."""
    with open(path, "w") as f:
        f.write("{" + ", ".join(f"{json.dumps(k)}: {_yml_value(v)}"
                                for k, v in values.items()) + "}")


def add_device_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the card, and an error "
                        "where there is none ('cpu' has to be asked for)")
    return p


def add_trace_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--trace_dir``, shared by the predict and training CLIs."""
    p.add_argument("--trace_dir", type=str, default=None, metavar="DIR",
                   help="profile the whole run, every thread (a server's "
                        "too), host and device, and write its Chrome trace "
                        "to DIR/trace.json (utils/profiling.trace)")
    return p


def parse_config_args(argv: Sequence[str] | None = None):
    """Reference-compatible entry: returns (Config, argparse.Namespace)."""
    args = build_arg_parser().parse_args(argv)
    cfg = load_config(args.config, args.config_dir)
    return cfg, args
