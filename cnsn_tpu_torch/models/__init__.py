"""Model registry: port of ``cnsn_tpu/models/__init__.py::build_model``,
plus ``build_classifier``, the entry point that places an eval model on
a device."""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..nn.cnsn import set_num_groups
from ..utils.device import resolve_device
from .allconv import AllConvNet
from .densenet import DenseNet, densenet
from .resnet import ResNet, resnet50
from .resnet_ibn import ResNetIBN, resnet50_ibn_a, resnet50_ibn_b
from .resnext import CifarResNeXt, resnext29
from .wideresnet import WideResNet

__all__ = ["AllConvNet", "CifarResNeXt", "DenseNet", "ResNet", "ResNetIBN",
           "WideResNet", "densenet", "resnet50", "resnet50_ibn_a",
           "resnet50_ibn_b", "resnext29", "build_model", "build_classifier"]

_RESNETS = {"resnet50": resnet50, "resnet50_ibn_a": resnet50_ibn_a,
            "resnet50_ibn_b": resnet50_ibn_b}


def build_model(name: str, num_classes: int,
                generator: Optional[torch.Generator] = None,
                num_groups: int = 1, **knobs: Any) -> nn.Module:
    """Build a model by reference-script name on the CPU.

    knobs: pos, crop, beta, cnsn_type, dtype, and ``layers`` and
    ``remat`` for resnet50, resnet50_ibn_a and resnet50_ibn_b; None
    values take the model's defaults, as in the JAX registry.
    ``num_groups``: the CrossNorm sites pair within that many contiguous
    blocks of the global batch (the data-parallel width, one block a
    rank; ``nn/cnsn.py::set_num_groups``).
    ``wideresnet`` is WRN-40-2 without dropout, ``densenet``
    DenseNet-40-12 and ``resnext`` ResNeXt-29 4×32d, as there; AllConvNet
    takes ``pos`` as an int (the recipes write '1').
    """
    return set_num_groups(_build(name, num_classes, generator, knobs),
                          num_groups)


def _build(name, num_classes, generator, knobs):
    knobs = {k: v for k, v in knobs.items() if v is not None}
    if name == "wideresnet":
        return WideResNet(depth=40, widen_factor=2, num_classes=num_classes,
                          generator=generator, **knobs)
    if name == "allconv":
        if "pos" in knobs:
            knobs["pos"] = int(knobs["pos"])
        return AllConvNet(num_classes=num_classes, generator=generator,
                          **knobs)
    if name == "densenet":
        return densenet(num_classes=num_classes, generator=generator, **knobs)
    if name == "resnext":
        return resnext29(num_classes=num_classes, generator=generator,
                         **knobs)
    if name in _RESNETS:
        return _RESNETS[name](num_classes=num_classes, generator=generator,
                              **knobs)
    raise ValueError(f"unknown model: {name}")


def build_classifier(name: str = "resnet50", num_classes: int = 1000, *,
                     device: str | torch.device = "cuda", seed: int = 0,
                     **knobs: Any) -> nn.Module:
    """An eval-mode classifier with random weights drawn from ``seed``, on
    ``device`` (the card unless the caller asks for the CPU; raises when
    CUDA is asked for and absent).  The weights are drawn on the CPU, so
    one seed gives the same model on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = build_model(name, num_classes, generator=gen, **knobs)
    return model.to(dev).eval()
