"""Scalar logging and a wall-clock probe.

Counterpart of ``osvos_tpu/utils/logging.py``. The reference logs its
losses through tensorboardX under the names ``total_loss_iter``,
``total_loss_epoch`` and ``val_loss_epoch``; ``ScalarLogger`` keeps those
names, writes every scalar as a JSON line to ``<log_dir>/scalars.jsonl``
and, where tensorboard (tensorboardX, the reference's, or PyTorch's writer)
imports, to an event file too.
"""

from __future__ import annotations

import importlib
import json
import os
import time


def _tensorboard_writer(log_dir: str):
    """A SummaryWriter of tensorboardX or torch.utils.tensorboard, or None
    when neither imports."""
    for module in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return importlib.import_module(module).SummaryWriter(log_dir)
        except Exception:  # not installed, or its dependencies are not
            continue
    return None


class ScalarLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "scalars.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = _tensorboard_writer(log_dir) if use_tensorboard else None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Seconds since construction, on the host's monotonic clock."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0
