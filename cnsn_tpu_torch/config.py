"""Experiment configuration: port of ``cnsn_tpu/config.py`` for the fields
the serving and training slices read.

The same YAML recipes load (``cnsn_tpu/configs/**.yaml``, read as data):
the fields below are typed, with the JAX package's defaults, and every
other key is kept in ``extra`` rather than rejected, so each recipe
loads.  ``infer()`` derives ``num_classes`` and resolves
``regime: auto`` by the JAX package's rules.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import yaml

__all__ = ["ExperimentConfig", "load_config", "apply_overrides"]


@dataclass
class ExperimentConfig:
    exp_id: str = "cnsn"
    seed: int = 1
    dataset: str = "cifar10"          # cifar10 | cifar100 | imagenet
    model: str = "wideresnet"
    num_classes: int = 10
    cnsn_type: Optional[str] = None   # sn | cn | cnsn | None
    pos: Optional[str] = None
    crop: Optional[str] = None
    beta: Optional[float] = None
    cn_prob: Optional[float] = None
    active_num: Optional[int] = None  # CrossNorm sites on per cn step
    # plain | cn | cn_consistency | cn_augmix | cn_image | cn_image_consist
    # | cn_image_augmix, or auto (resolved by infer())
    regime: str = "plain"
    epochs: int = 100
    batch_size: int = 128
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = True
    schedule: str = "cosine"          # cosine | imagenet_step | poly
    compute_dtype: str = "fp32"       # fp32 | bf16 (params stay fp32)
    image_size: Optional[int] = None  # default: 32 (CIFAR) / 224 (ImageNet)
    extra: Dict[str, Any] = field(default_factory=dict)

    def infer(self) -> "ExperimentConfig":
        """Fill ``num_classes`` from the dataset and resolve
        ``regime: auto`` from the dataset, ``exp_id`` and ``cnsn_type``,
        by the JAX rules (``cnsn_tpu/config.py:97-128``)."""
        cfg = dataclasses.replace(self, extra=dict(self.extra))
        ds = cfg.dataset.replace("-", "").lower()
        cfg.dataset = ds
        cfg.num_classes = {"cifar10": 10, "cifar100": 100,
                           "imagenet": 1000}.get(ds, cfg.num_classes)
        if cfg.regime == "auto":
            cfg.regime = _auto_regime(ds, cfg.exp_id, cfg.cnsn_type or "")
        return cfg

    @property
    def resolved_image_size(self) -> int:
        if self.image_size:
            return self.image_size
        return 224 if self.dataset == "imagenet" else 32


def _auto_regime(dataset: str, exp_id: str, cnsn_type: str) -> str:
    if dataset == "imagenet":
        for key, regime in (("augmix", "cn_image_augmix"),
                            ("consist", "cn_image_consist"),
                            ("cn", "cn_image")):
            if key in exp_id:
                return regime
        return "plain"
    if "cn" not in cnsn_type:
        return "plain"
    if "augmix" in exp_id:
        return "cn_augmix"
    if "consist" in exp_id:
        return "cn_consistency"
    return "cn"


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
