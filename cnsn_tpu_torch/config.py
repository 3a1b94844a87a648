"""Experiment configuration: port of ``cnsn_tpu/config.py`` for the fields
the serving slice reads.

The same YAML recipes load (``cnsn_tpu/configs/**.yaml``, read as data):
the fields below are typed, and every other key is kept in ``extra``
rather than rejected, so each recipe loads.  ``infer()`` derives
``num_classes`` from the dataset by the JAX package's rules.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import yaml

__all__ = ["ExperimentConfig", "load_config", "apply_overrides"]


@dataclass
class ExperimentConfig:
    dataset: str = "cifar10"          # cifar10 | cifar100 | imagenet
    model: str = "wideresnet"
    num_classes: int = 10
    cnsn_type: Optional[str] = None   # sn | cn | cnsn | None
    pos: Optional[str] = None
    crop: Optional[str] = None
    beta: Optional[float] = None
    compute_dtype: str = "fp32"       # fp32 | bf16 (params stay fp32)
    image_size: Optional[int] = None  # default: 32 (CIFAR) / 224 (ImageNet)
    extra: Dict[str, Any] = field(default_factory=dict)

    def infer(self) -> "ExperimentConfig":
        """Fill ``num_classes`` from the dataset, by the JAX rules
        (``cnsn_tpu/config.py:97-110``)."""
        cfg = dataclasses.replace(self, extra=dict(self.extra))
        ds = cfg.dataset.replace("-", "").lower()
        cfg.dataset = ds
        cfg.num_classes = {"cifar10": 10, "cifar100": 100,
                           "imagenet": 1000}.get(ds, cfg.num_classes)
        return cfg

    @property
    def resolved_image_size(self) -> int:
        if self.image_size:
            return self.image_size
        return 224 if self.dataset == "imagenet" else 32


_FIELDS = tuple(f.name for f in dataclasses.fields(ExperimentConfig)
                if f.name != "extra")


def _split(data: Dict[str, Any]):
    known = {k: v for k, v in data.items() if k in _FIELDS}
    return known, {k: v for k, v in data.items() if k not in _FIELDS}


def load_config(path: Optional[str] = None,
                **overrides: Any) -> ExperimentConfig:
    data: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    data.update({k: v for k, v in overrides.items() if v is not None})
    known, extra = _split(data)
    return ExperimentConfig(**known, extra=extra).infer()


def apply_overrides(cfg: ExperimentConfig, pairs) -> ExperimentConfig:
    """CLI ``key=value`` overrides, values parsed as YAML scalars."""
    data = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise ValueError(f"override {pair!r} is not key=value")
        data[key] = yaml.safe_load(raw)
    known, extra = _split(data)
    return dataclasses.replace(cfg, **known,
                               extra={**cfg.extra, **extra}).infer()
