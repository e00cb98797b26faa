"""Metrics sinks: JSONL, TensorBoard and W&B (the JAX package's
training/metrics.py). One ``MetricsLogger`` hands each logged step's
scalars to every configured sink; the TensorBoard and W&B sinks warn and
drop their lines when their package is missing.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional


class JsonlSink:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, metrics: Dict[str, float]):
        # Strict JSON: NaN/Inf are not valid tokens; stringify them so the
        # exact lines that matter for fault diagnosis stay parseable.
        clean = {k: (v if not (isinstance(v, float)
                               and not math.isfinite(v)) else str(v))
                 for k, v in metrics.items()}
        self._f.write(json.dumps(
            {"step": step, "ts": time.time(), **clean}) + "\n")

    def close(self):
        self._f.close()


class TensorBoardSink:
    """Optional (--tensorboard-dir): torch.utils.tensorboard, which needs
    the tensorboard package."""

    def __init__(self, log_dir: str, warn=None):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(log_dir=log_dir)
        except Exception as e:
            if warn is not None:
                warn(f"tensorboard sink disabled: {type(e).__name__}: {e}")
            self._w = None

    def log(self, step: int, metrics: Dict[str, float]):
        if self._w is None:
            return
        for k, v in metrics.items():
            try:
                self._w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._w is not None:
            self._w.close()


class WandbSink:
    """Optional: degrades to a no-op with a warning when the wandb
    package is absent."""

    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[dict] = None, warn=None):
        try:
            import wandb
            self._run = wandb.init(project=project, name=name,
                                   config=config or {})
            self._wandb = wandb
        except Exception as e:
            if warn is not None:
                warn(f"wandb sink disabled: {type(e).__name__}: {e}")
            self._run = None

    def log(self, step: int, metrics: Dict[str, float]):
        if self._run is None:
            return
        self._wandb.log(dict(metrics), step=step)

    def close(self):
        if self._run is not None:
            self._run.finish()


class MetricsLogger:
    def __init__(self):
        self._sinks: List = []

    def add_jsonl(self, path: str):
        self._sinks.append(JsonlSink(path))
        return self

    def add_tensorboard(self, log_dir: str, warn=None):
        self._sinks.append(TensorBoardSink(log_dir, warn=warn))
        return self

    def add_wandb(self, project: str, name: Optional[str] = None,
                  config: Optional[dict] = None, warn=None):
        self._sinks.append(WandbSink(project, name, config, warn=warn))
        return self

    def log(self, step: int, metrics: Dict[str, float]):
        clean = {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in metrics.items()}
        for s in self._sinks:
            s.log(step, clean)

    def close(self):
        for s in self._sinks:
            s.close()
