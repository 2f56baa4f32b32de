"""Metrics/observability: W&B when available, JSONL + stdout always
(``sd_video_gen_tpu/train/metrics.py``; the port keeps its own copy).

The reference hard-depends on wandb (sweep, per-epoch logs — trainers/
trainer.py:183-188,486-565). Here wandb is optional: every run writes
newline-delimited JSON records to ``logs/<run_name>.jsonl`` (hermetic,
greppable), mirrors scalars to stdout, and forwards to wandb when the
package is importable and not disabled (--debug flag semantics:
trainers/trainer.py:309-311).
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, run_name: str, log_dir: str = "logs",
                 use_wandb: bool = True, wandb_config: dict | None = None,
                 quiet: bool = False):
        self.run_name = run_name
        self.quiet = quiet
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._f = open(self._path, "a")
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # optional dependency
                self._wandb = wandb
                wandb.init(project="sd-video-gen-torch", name=run_name,
                           config=wandb_config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: int | None = None) -> None:
        rec = {"t": round(time.time() - self._t0, 3), **{
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in metrics.items()}}
        if step is not None:
            rec["step"] = int(step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if not self.quiet:
            kv = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in rec.items() if k != "t")
            print(f"[{self.run_name}] {kv}")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
