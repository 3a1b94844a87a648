"""Experiment-dir provenance: code/config snapshot and log tee.  Port of
``cnsn_tpu/utils/provenance.py``.

The reference launcher copies the training script and config YAML into the
experiment dir and tees stdout to a timestamped log
(segmentation/tool/train_cnsn.sh), so every result directory records what
produced it.  Here the whole ``cnsn_tpu_torch`` package (its Python and
CUDA sources) is zipped, the resolved config dataclass is dumped as YAML,
and the current git revision (where there is one) is recorded.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
import zipfile
from typing import Any, Optional

__all__ = ["snapshot_experiment", "TeeLog"]

# what the code snapshot keeps: sources, not the kernels' build directory
_SOURCES = (".py", ".yaml", ".cu", ".cuh")
_SKIP_DIRS = ("__pycache__", "_build")


class TeeLog:
    """Mirror a stream (stdout/stderr) into a log file."""

    def __init__(self, stream, path: str):
        self._stream = stream
        self._f = open(path, "a", buffering=1)

    def write(self, s):
        self._stream.write(s)
        self._f.write(s)
        return len(s)

    def flush(self):
        self._stream.flush()
        self._f.flush()

    def close(self):
        self._f.close()

    def __getattr__(self, name):
        return getattr(self._stream, name)


def _git_rev(root: str) -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def snapshot_experiment(exp_dir: str, config: Any = None,
                        tee: bool = True) -> dict:
    """Write config.yaml + code-<ts>.zip + code_version.txt into
    ``exp_dir``; optionally tee stdout/stderr to train-<ts>.log.
    Returns {"log": path|None, "code": path, "config": path|None}.
    """
    os.makedirs(exp_dir, exist_ok=True)
    now = time.strftime("%Y%m%d_%H%M%S")
    out = {"log": None, "config": None}

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code_zip = os.path.join(exp_dir, f"code-{now}.zip")
    with zipfile.ZipFile(code_zip, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, dirnames, files in os.walk(pkg_root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in files:
                if fn.endswith(_SOURCES):
                    full = os.path.join(dirpath, fn)
                    z.write(full, os.path.relpath(full,
                                                  os.path.dirname(pkg_root)))
    out["code"] = code_zip

    rev = _git_rev(os.path.dirname(pkg_root))
    if rev:
        with open(os.path.join(exp_dir, "code_version.txt"), "w") as f:
            f.write(rev + "\n")

    if config is not None:
        import yaml
        cfg_path = os.path.join(exp_dir, "config.yaml")
        payload = (dataclasses.asdict(config)
                   if dataclasses.is_dataclass(config) else dict(config))
        with open(cfg_path, "w") as f:
            yaml.safe_dump(payload, f, sort_keys=True)
        out["config"] = cfg_path

    if tee:
        log_path = os.path.join(exp_dir, f"train-{now}.log")
        sys.stdout = TeeLog(sys.stdout, log_path)
        sys.stderr = TeeLog(sys.stderr, log_path)
        out["log"] = log_path
    return out
