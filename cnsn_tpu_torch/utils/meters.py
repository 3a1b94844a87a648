"""Running-average meters and experiment-dir helpers: port of
``cnsn_tpu/utils/meters.py`` (reference: utils.py:11-60)."""
from __future__ import annotations

import os
from time import strftime

__all__ = ["AverageMeter", "get_log_dir_path"]


class AverageMeter:
    """Stores current value, running sum, and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def get_log_dir_path(root_path: str, run_name: str) -> str:
    """experiments/<date>/<run_name>_<time> layout (utils.py:11-24)."""
    date_stamp = strftime("%Y_%m_%d")
    time_stamp = strftime("%H_%M_%S")
    return os.path.join(root_path, date_stamp, f"{run_name}_{time_stamp}")
