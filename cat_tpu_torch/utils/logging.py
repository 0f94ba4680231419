"""Metric logging: JSONL always; TensorBoard or Weights & Biases on top
(the port's copy of cat_tpu/utils/logging.py).

Each line of ``metrics.jsonl`` is ``{"step": iteration, <name>: float,
...}`` with the reference's names (Loss/*, Train/*, Episode/*,
Episode_Constraint_violation/cstr_*, Episode_Constraint_probability/cstr_*,
Curriculum/*, Constraint_running_max/cstr_*, Perf/*), so the port's curves
and the JAX package's read side by side. ``writer="tensorboard"`` (the
default) adds a SummaryWriter and ``writer="wandb"`` a W&B run, each only
when its package imports; without it the logger prints why and keeps
writing JSONL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, run_path: str, writer: str = "tensorboard",
                 wandb_init_kwargs: Optional[dict] = None):
        if writer not in ("tensorboard", "wandb", "none"):
            raise ValueError(f"unknown writer {writer!r}")
        self.run_path = run_path
        os.makedirs(run_path, exist_ok=True)
        self._tb = None
        self._wandb = None
        if writer == "wandb":
            try:
                import wandb

                wandb.init(dir=run_path, **(wandb_init_kwargs or {}))
                self._wandb = wandb
            except Exception as e:  # no package, no network: JSONL stays on
                print(f"wandb writer unavailable ({e}); logging JSONL only")
        elif writer == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=run_path)
            except ImportError as e:
                print(f"tensorboard writer unavailable ({e}); logging JSONL "
                      "only")
        self._jsonl = open(os.path.join(run_path, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, float], step: int):
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"},
                            step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
