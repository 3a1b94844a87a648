"""Structured metric logging: port of ``cnsn_tpu/utils/metrics_io.py``.

JSONL scalars, one object a line; ``tensorboard=True`` also mirrors every
scalar into TensorBoard event files (torch's SummaryWriter, imported when
asked for and skipped where it is absent).
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["MetricWriter"]


class MetricWriter:
    def __init__(self, log_dir: str, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:  # keep JSONL-only on minimal images
                pass

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "wall_time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._f.close()
