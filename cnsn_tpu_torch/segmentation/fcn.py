"""FCN segmentation heads and the FCN-CNSN model: port of
``cnsn_tpu/segmentation/fcn.py`` (reference segmentation/model/fcn.py:
82-126 FCN_CNSN; torchvision FCNHead).

Head = 3×3 conv (C → C/4, no bias) → BN → ReLU → Dropout(0.1) → 1×1 conv
(C/4 → classes, with bias), as torchvision's ``nn.Sequential``, so its
state-dict keys are the reference's (``classifier.0.weight``,
``classifier.1.running_mean``, ``classifier.4.bias``); the main head on
layer4 (2048 channels), the aux head on layer3 (1024).  The logits are
upsampled bilinearly to the input size (``F.interpolate(align_corners=
False)``, which is ``jax.image.resize('bilinear')`` when upscaling), or
returned at stride 8 for the fused loss (``upsample=False``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import Conv2d
from ..nn.norm import BatchNorm
from .backbone import DilatedConv, seg_resnet50

__all__ = ["ClsHead", "FCNHead", "FCNCNSN", "fcn_cnsn", "fcn_baseline"]


def _lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv init: truncated normal (±2σ), variance 1/fan_in,
    for an OIHW shape."""
    fan_in = shape[1] * shape[2] * shape[3]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    return w


class _ReLU(nn.Module):
    """``nn.ReLU`` through this module's ``F`` (which
    ``train/rounding.py`` replaces to record or replay the masks)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class ClsHead(nn.Sequential):
    """3×3 conv (in_channels → width, no bias) → BN → ReLU → Dropout → 1×1
    conv (width → classes, with bias): the FCN heads' and the PSP/PSA
    heads' ``cls`` and ``aux`` (JAX ``pspnet.py:_ClsHead``)."""

    def __init__(self, in_channels: int, width: int, classes: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        g = generator or torch.Generator()
        cls = Conv2d(width, classes, 1, dtype=dtype, generator=g, bias=True)
        with torch.no_grad():
            cls.weight.copy_(_lecun_normal(tuple(cls.weight.shape), g))
        super().__init__(DilatedConv(in_channels, width, 3, dtype=dtype,
                                     generator=g),
                         BatchNorm(width), _ReLU(), nn.Dropout(dropout),
                         cls)


class FCNHead(ClsHead):
    def __init__(self, in_channels: int, classes: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, in_channels // 4, classes, dropout,
                         dtype, generator)


class FCNCNSN(nn.Module):
    """FCN-ResNet50 with a CNSN backbone: NHWC images → (out, aux)
    logits, NHWC, at the input size (or at stride 8 with
    ``upsample=False``).  The backbone comes from this module's
    ``seg_resnet50``, as in the JAX package (replace it to cut the
    depth)."""

    def __init__(self, classes: int = 19, block_idxs: str = "1_2_3_4",
                 pos: Optional[str] = "residual",
                 cn_pos: Optional[str] = "post",
                 cnsn_type: Optional[str] = "cnsn", crop: str = "style",
                 beta: float = 1.0, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, remat: Any = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        self.backbone = seg_resnet50(
            block_idxs=block_idxs, pos=pos, cn_pos=cn_pos,
            cnsn_type=cnsn_type, crop=crop, beta=beta, dtype=dtype,
            remat=remat, generator=g)
        self.classifier = FCNHead(2048, classes, dropout, dtype, g)
        self.aux_classifier = FCNHead(1024, classes, dropout, dtype, g)

    @property
    def cn_num(self) -> int:
        return self.backbone.cn_num

    @property
    def has_img_cn(self) -> bool:
        return self.backbone.has_img_cn

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                img_cn_active: Optional[bool] = None,
                upsample: bool = True,
                cn_draws: Optional[Sequence[dict]] = None,
                img_cn_draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """``upsample=False`` returns the raw stride-8 head logits, for the
        class-major fused upsample + cross-entropy (``upsample.py``)."""
        feats = self.backbone(images, cn_active, img_cn_active, cn_draws,
                              img_cn_draws, generator)
        out = self.classifier(feats["out"].permute(0, 3, 1, 2))
        aux = self.aux_classifier(feats["aux"].permute(0, 3, 1, 2))
        if upsample:
            size = tuple(images.shape[1:3])

            def up(z):
                z = z.to(torch.promote_types(z.dtype, torch.float32))
                return F.interpolate(z, size=size, mode="bilinear",
                                     align_corners=False)

            out, aux = up(out), up(aux)
        return out.permute(0, 2, 3, 1), aux.permute(0, 2, 3, 1)


def fcn_cnsn(classes: int, **kw) -> FCNCNSN:
    return FCNCNSN(classes=classes, **kw)


def fcn_baseline(classes: int, **kw) -> FCNCNSN:
    """Plain FCN-ResNet50 (reference FCNet, segmentation/model/fcn.py:
    15-53): the same topology with no CNSN modules."""
    return FCNCNSN(classes=classes, cnsn_type=None, block_idxs="",
                   pos=None, cn_pos=None, **kw)
