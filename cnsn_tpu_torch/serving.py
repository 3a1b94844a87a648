"""Serving: portable artifacts of the eval forward.  Port of
``cnsn_tpu/serving.py`` (``export_classifier``, ``export_segmenter``,
``save_artifact``, ``load_artifact``).

The eval forward is exported ONCE with ``torch.export``: a symbolic batch
dimension, the weights inside the artifact, one ``.pt2`` file.  Serving
it needs no model code, with one difference from the JAX artifact: the
fused SelfNorm is a custom op, ``torch.ops.cnsn_tpu_torch.selfnorm_infer``,
so the serving process must ``import cnsn_tpu_torch.ops`` (which
registers it) before loading.  ``load_artifact`` does that itself.

Usage:
    model = build_classifier("resnet50", cnsn_type="sn", pos="post")
    save_artifact(export_classifier(model, image_size=224), "rn50_sn.pt2")
    ...
    serve = load_artifact("rn50_sn.pt2")
    logits = serve(images)        # NHWC float32, any batch size
"""
from __future__ import annotations

from typing import Callable

import torch

from . import ops  # noqa: F401  (registers the custom op for load/export)
from .utils.device import resolve_device

__all__ = ["export_classifier", "export_segmenter", "save_artifact",
           "load_artifact"]

# Largest batch a symbolic-batch artifact accepts.
MAX_BATCH = 4096


def _export(module: torch.nn.Module, hw) -> torch.export.ExportedProgram:
    """``module``'s eval forward on NHWC float32 images of ``hw``, on the
    device its weights are on, the batch symbolic (1 to ``MAX_BATCH``)."""
    device = next(module.parameters()).device
    example = torch.zeros(2, hw[0], hw[1], 3, device=device)
    dynamic = ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        return torch.export.export(module.eval(), (example,),
                                   dynamic_shapes=dynamic)


def export_classifier(model: torch.nn.Module, image_size: int
                      ) -> torch.export.ExportedProgram:
    """Export a classifier's eval forward (NHWC float32 images → logits)
    on the device its weights are on.

    The batch dimension is symbolic (1 to ``MAX_BATCH``): one artifact
    serves every batch size.  Parameters and running statistics are
    carried inside the program.
    """
    return _export(model, (image_size, image_size))


class _MainLogits(torch.nn.Module):
    """A segmenter's eval forward with its main head's logits alone."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images)[0]


def export_segmenter(model: torch.nn.Module, hw
                     ) -> torch.export.ExportedProgram:
    """Export a segmenter's eval forward (JAX ``serving.py:98-108``): NHWC
    float32 images of ``hw`` = (H, W) → the main head's per-pixel logits
    at input resolution (the reference's eval contract, segmentation/
    model/fcn.py:120-126), on the device its weights are on.  The batch
    is symbolic (1 to ``MAX_BATCH``), the weights are inside."""
    return _export(_MainLogits(model), hw)


def save_artifact(exported: torch.export.ExportedProgram, path: str) -> None:
    """Serialize an exported program to one file."""
    torch.export.save(exported, path)


def load_artifact(path: str, device: str | torch.device = "cuda"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an artifact as a callable on ``device`` (the card unless the
    caller asks for the CPU).  The artifact's weights are moved there."""
    dev = resolve_device(device)
    module = torch.export.load(path).module().to(dev)

    def serve(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(images)

    return serve
