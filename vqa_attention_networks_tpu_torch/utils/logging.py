"""Structured metric writer (the port's copy of
``vqa_attention_networks_tpu/utils/logging.py``).

The reference logs per-epoch scalars through tensorboardX
(solver.py:31,116-117) under the tags ``<model>/loss`` and ``<model>/acc``.
This writer keeps those tags and writes:

- a JSONL event stream, ``<log_dir>/<run>/events.jsonl``, always;
- TensorBoard, through ``tensorboardX`` or ``torch.utils.tensorboard``,
  only when ``VQA_TENSORBOARD`` is set (its writer threads are unwanted on
  a small host).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class NullMetricWriter:
    """A writer that writes nothing."""

    def add_scalars(self, tag, values, step) -> None:
        pass

    def add_scalar(self, tag, value, step) -> None:
        pass

    def close(self) -> None:
        pass


class MetricWriter:
    def __init__(self, log_dir: str = "runs", run_name: Optional[str] = None):
        run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.log_dir = os.path.join(log_dir, run_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "events.jsonl"), "a")
        self._tb = self._try_tensorboard()

    def _try_tensorboard(self):
        if not os.environ.get("VQA_TENSORBOARD"):
            return None
        for modname, attr in (("tensorboardX", "SummaryWriter"),
                              ("torch.utils.tensorboard", "SummaryWriter")):
            try:
                mod = __import__(modname, fromlist=[attr])
                return getattr(mod, attr)(self.log_dir)
            except Exception:  # a missing or broken TensorBoard: JSONL only
                continue
        return None

    def add_scalars(self, tag: str, values: Dict[str, float],
                    step: int) -> None:
        """One event: ``{"tag", "step", "time", <metric>: value, ...}``; a
        metric named like a metadata field is written as ``metric_<name>``
        so that it cannot overwrite the event's identity."""
        rec = {"tag": tag, "step": int(step), "time": time.time()}
        for k, v in values.items():
            key = f"metric_{k}" if k in ("tag", "step", "time") else k
            rec[key] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, values, step)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars(tag, {"value": value}, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
