"""Model registry: port of ``cnsn_tpu/models/__init__.py::build_model``,
plus ``build_classifier``, the entry point that places an eval model on
a device."""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..utils.device import resolve_device
from .resnet import ResNet, resnet50

__all__ = ["ResNet", "resnet50", "build_model", "build_classifier"]

# Models of the JAX package that this port does not have yet.
_NOT_PORTED = ("wideresnet", "allconv", "densenet", "resnext",
               "resnet50_ibn_a", "resnet50_ibn_b")


def build_model(name: str, num_classes: int,
                generator: Optional[torch.Generator] = None,
                **knobs: Any) -> ResNet:
    """Build a model by reference-script name on the CPU.

    knobs: layers, pos, crop, beta, cnsn_type, dtype; None values take
    the model's defaults, as in the JAX registry.
    """
    knobs = {k: v for k, v in knobs.items() if v is not None}
    if name == "resnet50":
        return resnet50(num_classes=num_classes, generator=generator, **knobs)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not yet ported to "
                                  f"cnsn_tpu_torch")
    raise ValueError(f"unknown model: {name}")


def build_classifier(name: str = "resnet50", num_classes: int = 1000, *,
                     device: str | torch.device = "cuda", seed: int = 0,
                     **knobs: Any) -> ResNet:
    """An eval-mode classifier with random weights drawn from ``seed``, on
    ``device`` (the card unless the caller asks for the CPU; raises when
    CUDA is asked for and absent).  The weights are drawn on the CPU, so
    one seed gives the same model on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = build_model(name, num_classes, generator=gen, **knobs)
    return model.to(dev).eval()
