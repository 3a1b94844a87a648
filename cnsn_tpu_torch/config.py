"""Experiment configuration: port of ``cnsn_tpu/config.py``.

One dataclass with every field of the JAX package and its defaults; the
YAML recipes under ``cnsn_tpu/configs/`` load as data, and a key that is
not a field raises, as in the JAX package (``config.py:138-141``,
``:152-153``).  ``infer()`` derives ``num_classes`` and resolves
``regime: auto`` by the JAX package's rules.  Fields whose feature the
port does not have yet load here and raise where they would be used
(``train/trainer.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import yaml

__all__ = ["ExperimentConfig", "load_config", "apply_overrides"]


@dataclass
class ExperimentConfig:
    # experiment
    exp_id: str = "cnsn"
    exp_dir: str = "./exp"
    seed: int = 1

    # data
    dataset: str = "cifar10"          # cifar10 | cifar100 | imagenet
    data_dir: str = "./data"
    corrupt_data_dir: Optional[str] = None
    workers: int = 4
    augmix_workers: int = 0           # worker processes for host AugMix
    prefetch_depth: int = 2           # host→device staging depth (0: none)
    synthetic_data: bool = False

    # model
    model: str = "wideresnet"
    num_classes: int = 10

    # CN/SN knobs (reference names)
    cnsn_type: Optional[str] = None   # sn | cn | cnsn | None
    pos: Optional[str] = None
    crop: Optional[str] = None
    beta: Optional[float] = None
    cn_prob: Optional[float] = None
    active_num: Optional[int] = None  # CrossNorm sites on per cn step
    consist_wt: Optional[float] = None

    # plain | cn | cn_consistency | cn_augmix | cn_image | cn_image_consist
    # | cn_image_augmix, or auto (resolved by infer())
    regime: str = "plain"

    # optimization
    epochs: int = 100
    batch_size: int = 128
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = True
    schedule: str = "cosine"          # cosine | imagenet_step | poly

    # augmix
    aug_severity: float = 3
    mixture_width: int = 3
    mixture_depth: int = -1
    all_ops: bool = False
    ondevice_augmix: bool = False
    no_jsd: bool = False

    # runtime
    print_freq: int = 10
    eval_batch_size: int = 1000
    # 'msgpack': single files (``utils/checkpoint.py``); 'orbax': step
    # checkpoints, async saves, SIGTERM flush (``utils/orbax_io.py``)
    ckpt_backend: str = "msgpack"
    snapshot: bool = True             # code + config into the exp dir
    resume: Optional[str] = None
    pretrained: Optional[str] = None  # torch .pth partial init
    evaluate: bool = False
    num_devices: Optional[int] = None
    fsdp: bool = False
    compute_dtype: str = "fp32"       # fp32 | bf16 (params stay fp32)
    remat: bool = False               # rematerialise ResNet bottlenecks
    image_size: Optional[int] = None  # default: 32 (CIFAR) / 224 (ImageNet)

    def infer(self) -> "ExperimentConfig":
        """Fill ``num_classes`` from the dataset and resolve
        ``regime: auto`` from the dataset, ``exp_id`` and ``cnsn_type``,
        by the JAX rules (``cnsn_tpu/config.py:97-128``)."""
        cfg = dataclasses.replace(self)
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


_FIELDS = frozenset(f.name for f in dataclasses.fields(ExperimentConfig))


def load_config(path: Optional[str] = None,
                **overrides: Any) -> ExperimentConfig:
    data: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    data.update({k: v for k, v in overrides.items() if v is not None})
    unknown = set(data) - _FIELDS
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return ExperimentConfig(**data).infer()


def apply_overrides(cfg: ExperimentConfig, pairs) -> ExperimentConfig:
    """CLI ``key=value`` overrides, values parsed as YAML scalars."""
    updates = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise ValueError(f"override {pair!r} is not key=value")
        if key not in _FIELDS:
            raise ValueError(f"unknown config key: {key}")
        updates[key] = yaml.safe_load(raw)
    return dataclasses.replace(cfg, **updates).infer()
