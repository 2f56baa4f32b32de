"""Checkpoints: parameters + optimizer state + step, reference-style naming
(``sd_video_gen_tpu/train/checkpoint.py``).

The reference saved only ``model.state_dict()`` per epoch, so a resume
restarted Adam's moments. Here the full train state is checkpointed, and a
resumed run continues exactly. Names keep the reference scheme
``<config>_<index>_<mode>`` with ``<index>`` = count of existing entries
matching the config name, so prediction CLIs can address checkpoints
identically.

A checkpoint is a directory, as the JAX package's is: one torch file
(``state.pt``: ``{"step", "params", "mu", "nu"}``, the last three dicts of
tensors under the parameters' names) and the stamp ``sdvg_format.json`` with
the schema version, written once the file is complete. The JAX package
writes its directories with Orbax, which imports JAX: this module cannot read
those; a converter that imports both packages is separate work.

Format versions: v1 (no stamp) states predate the transformer's final stack
norms (``transformer.encoder.norm`` / ``transformer.decoder.norm``);
``restore_checkpoint`` migrates them by initialising the missing LayerNorms
to weight 1 / bias 0 with fresh (zero) Adam moments and a loud warning: the
v1 architecture applied NO final norm, so the migrated forward is
approximate, not bit-equal to what the old checkpoint produced.
"""

from __future__ import annotations

import json
import os
import threading
import warnings

import torch

FORMAT_VERSION = 2
_FORMAT_FILE = "sdvg_format.json"
_STATE_FILE = "state.pt"
_TREES = ("params", "mu", "nu")
# parameters added in v2 that v1 checkpoints lack
_V2_NEW_PARAMS = ("transformer.encoder.norm.", "transformer.decoder.norm.")


def checkpoint_index(checkpoint_dir: str, config_name: str) -> int:
    """Reference semantics: count existing entries containing the config name."""
    if not os.path.isdir(checkpoint_dir):
        return 0
    return len([n for n in os.listdir(checkpoint_dir) if config_name in n])


def checkpoint_path(checkpoint_dir: str, config_name: str, index: int,
                    mode: str) -> str:
    name = f"{config_name}_{index}_{mode}"
    return os.path.abspath(os.path.join(checkpoint_dir, name))


# -- saving -------------------------------------------------------------------
#
# A flagship train state is GBs (parameters + both moments); a synchronous
# save stalls the train loop for the whole disk write. A non-blocking save
# copies the state to host memory, returns, and writes in a background
# thread, so the loop overlaps the write with the next epochs. A new save
# first waits for the one before it, so at most one write is in flight;
# finalize_saves() drains it (fit end, interrupt, restore, process exit).

_PENDING: list = []        # (thread, path, errors) of the save in flight
_LOCK = threading.Lock()
_ATEXIT = False            # finalize_saves registered with atexit


def _stamp(path: str) -> None:
    with open(os.path.join(path, _FORMAT_FILE), "w") as f:
        json.dump({"format_version": FORMAT_VERSION}, f)


def _write(path: str, host_state: dict) -> None:
    os.makedirs(path, exist_ok=True)
    stamp = os.path.join(path, _FORMAT_FILE)
    if os.path.exists(stamp):     # a re-save: no stamp on a half-written dir
        os.remove(stamp)
    tmp = os.path.join(path, f"{_STATE_FILE}.{os.getpid()}.tmp")
    torch.save(host_state, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    _stamp(path)


def finalize_saves() -> None:
    """Block until the save in flight has been written and stamped; raise
    what its thread raised."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    for thread, path, errors in pending:
        thread.join()
        if errors:
            raise RuntimeError(f"saving {path} failed") from errors[0]


def _to_host(state: dict) -> dict:
    """A copy of ``state`` in host memory that later updates of the live
    tensors cannot reach."""
    return {"step": int(state["step"]),
            **{tree: {k: v.detach().to("cpu", copy=True)
                      for k, v in state[tree].items()} for tree in _TREES}}


def save_checkpoint(path: str, state: dict, block: bool = True) -> None:
    """Save the train state (``TrainState.state_dict()``) at ``path`` and
    stamp the format version.

    ``block=False`` returns as soon as the tensors are copied to host memory
    and lets the write run in a background thread; ``finalize_saves()`` must
    run before the checkpoint is read (restore and the Trainer's fit and
    interrupt paths do)."""
    path = os.path.abspath(path)
    finalize_saves()              # one write in flight at a time
    host = _to_host(state)
    if block:
        _write(path, host)
        return
    errors: list = []

    def run():
        try:
            _write(path, host)
        except BaseException as e:   # re-raised by finalize_saves
            errors.append(e)

    global _ATEXIT
    if not _ATEXIT:
        import atexit
        atexit.register(finalize_saves)
        _ATEXIT = True
    thread = threading.Thread(target=run, daemon=False)
    with _LOCK:
        _PENDING.append((thread, path, errors))
    thread.start()


def read_format_version(path: str) -> int:
    """Stamped version; 1 for pre-versioning checkpoints (no stamp file)."""
    p = os.path.join(os.path.abspath(path), _FORMAT_FILE)
    if not os.path.exists(p):
        return 1
    with open(p) as f:
        return int(json.load(f).get("format_version", 1))


# -- restoring ----------------------------------------------------------------

def _load(path: str) -> dict:
    return torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)


def _into(saved: dict, like: dict) -> dict:
    """``saved`` checked against the structure of ``like`` (same names,
    shapes and dtypes in every tree), its tensors on ``like``'s devices."""
    if not isinstance(saved, dict) or set(saved) != {"step", *_TREES}:
        raise ValueError(f"checkpoint holds {sorted(saved)}, expected "
                         f"{sorted(('step',) + _TREES)}")
    out = {"step": int(saved["step"])}
    for tree in _TREES:
        have, want = saved[tree], like[tree]
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        bad = sorted(k for k in set(have) & set(want)
                     if have[k].shape != want[k].shape
                     or have[k].dtype != want[k].dtype)
        if missing or extra or bad:
            raise ValueError(
                f"checkpoint {tree!r} does not match the train state: "
                f"{len(missing)} missing {missing[:5]}, {len(extra)} unknown "
                f"{extra[:5]}, mismatched " + "; ".join(
                    f"{k}: {tuple(have[k].shape)} {have[k].dtype} vs "
                    f"{tuple(want[k].shape)} {want[k].dtype}"
                    for k in bad[:5]))
        out[tree] = {k: have[k].to(want[k].device) for k in want}
    return out


def restore_checkpoint(path: str, like: dict) -> dict:
    """The state saved at ``path`` in the structure of ``like`` (a
    ``TrainState.state_dict()``), tensors on ``like``'s devices.

    Older-format checkpoints are migrated forward (see the module
    docstring); an unstamped checkpoint that already matches the current
    structure restores normally."""
    finalize_saves()  # never read a checkpoint whose save is in flight
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    return _restore(path, _load(path), like)


def _restore(path: str, saved: dict, like: dict) -> dict:
    if read_format_version(path) >= FORMAT_VERSION:
        return _into(saved, like)
    # unstamped: try the current structure first, then the v1 migration.
    # If the v1-shaped restore ALSO fails, the checkpoint was never a v1
    # state (wrong --config, corruption, ...): surface the ORIGINAL error
    # rather than a misleading 'migrating v1' story.
    try:
        return _into(saved, like)
    except Exception as current_err:
        try:
            return _restore_v1(path, saved, like)
        except Exception:
            raise current_err


def restore_params(path: str, model: torch.nn.Module) -> dict:
    """Only the parameters of the state saved at ``path`` (what the predict
    CLIs need), checked by name and shape against ``model``'s and migrated
    like ``restore_checkpoint``; the tensors keep the saved dtypes, on the
    CPU. The file is read once."""
    finalize_saves()
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    saved = _load(path)
    names = dict(model.named_parameters())

    def like(tree):
        # zero-stride stand-ins: the saved dtype, the model's shape, no
        # memory
        have = saved.get(tree, {}) if isinstance(saved, dict) else {}
        return {k: torch.empty((), dtype=have[k].dtype if k in have
                               else p.dtype).expand(p.shape)
                for k, p in names.items()}

    return _restore(path, saved, {"step": 0, **{tree: like(tree)
                                                for tree in _TREES}})["params"]


# -- v1 -> v2 migration ------------------------------------------------------

def _is_v2_new(name: str) -> bool:
    return name.startswith(_V2_NEW_PARAMS)


def _restore_v1(path: str, saved: dict, like: dict) -> dict:
    """Restore a pre-versioning state missing the final stack norms; fill
    them with identity LayerNorms + fresh moments."""
    old_like = {"step": like["step"],
                **{tree: {k: v for k, v in like[tree].items()
                          if not _is_v2_new(k)} for tree in _TREES}}
    old = _into(saved, old_like)
    # warn only once the v1-shaped restore actually succeeded: a failure
    # above means the checkpoint was never v1 and the caller surfaces the
    # original current-structure error instead
    warnings.warn(
        f"checkpoint {path} is format v1 (predates the transformer's final "
        "stack norms): migrating by initializing transformer.encoder.norm / "
        "transformer.decoder.norm to weight=1/bias=0 with fresh Adam "
        "moments. The v1 architecture applied no final LayerNorm, so the "
        "migrated forward is approximate — fine-tune or re-convert from a "
        "reference .pt for exactness.", stacklevel=3)
    out = {"step": old["step"]}
    for tree in _TREES:
        out[tree] = {}
        for k, want in like[tree].items():
            if k in old[tree]:
                out[tree][k] = old[tree][k]
            else:
                ones = tree == "params" and k.endswith(".weight")
                out[tree][k] = (torch.ones_like(want) if ones
                                else torch.zeros_like(want))
    return out
