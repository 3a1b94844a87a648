"""CIFAR ResNeXt-29 (4×32d) with CNSN, train and eval forward: port of
``cnsn_tpu/models/resnext.py``.

Bottlenecks of type C: 1×1 reduce → grouped 3×3 (``cardinality`` groups)
→ 1×1 expand, CNSN at one of {residual, identity, pre, post} per block;
3 stages of (depth − 2)/9 blocks, 9 CNSN sites at depth 29.  The grouped
3×3 convs stay cuDNN convs under every ``CNSN_CONV3X3`` (JAX keeps grouped
convs off its Pallas gradient); the 3→64 stem is the one 3×3 conv that
mode reaches.

The reference's quirk is kept (``:70-74``): at pos 'identity' a block
with a downsample runs its CNSN on the identity and then overwrites the
result with downsample(x); the site still runs (its BatchNorm1d running
statistics move, its CrossNorm draws are taken) and its parameters get a
zero gradient.  Module names follow the reference torch state dict
(``stage_1.0.conv_reduce``, ``stage_1.0.downsample.0``, ``conv_1_3x3``,
``bn_1``, ``classifier``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cnsn import CNSN
from ..nn.norm import BatchNorm
from .common import conv_he_fanout, linear_kaiming_normal, site_gates

__all__ = ["CifarResNeXt", "ResNeXtBottleneck", "resnext29"]

_POSITIONS = ("residual", "identity", "pre", "post")


class ResNeXtBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, cardinality: int,
                 base_width: int, pos: str, cnsn_type: str,
                 crop: str = "neither", beta: float = 1.0, stride: int = 1,
                 has_downsample: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos not in _POSITIONS:
            raise ValueError(f"bad pos {pos!r}: one of {_POSITIONS}")
        g = generator or torch.Generator()
        self.pos = pos
        width = int(math.floor(planes * (base_width / 64.0))) * cardinality
        out_ch = planes * self.expansion
        sn_feats = inplanes if pos in ("pre", "identity") else out_ch
        self.cnsn = CNSN(sn_feats, cnsn_type, crop=crop, beta=beta,
                         generator=g)
        self.conv_reduce = conv_he_fanout(inplanes, width, 1, dtype=dtype,
                                          generator=g)
        self.bn_reduce = BatchNorm(width)
        self.conv_conv = conv_he_fanout(width, width, 3, stride, dtype=dtype,
                                        generator=g, groups=cardinality)
        self.bn = BatchNorm(width)
        self.conv_expand = conv_he_fanout(width, out_ch, 1, dtype=dtype,
                                          generator=g)
        self.bn_expand = BatchNorm(out_ch)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                conv_he_fanout(inplanes, out_ch, 1, stride, dtype=dtype,
                               generator=g),
                BatchNorm(out_ch))

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def cnsn(t):
            return self.cnsn(t, active, draws, generator)

        residual = x
        if self.pos == "pre":
            x = cnsn(x)
        b = F.relu(self.bn_reduce(self.conv_reduce(x)))
        b = F.relu(self.bn(self.conv_conv(b)))
        b = self.bn_expand(self.conv_expand(b))
        if self.pos == "residual":
            b = cnsn(b)
        elif self.pos == "identity":
            residual = cnsn(residual)
        if self.downsample is not None:
            # overwrites an 'identity' CNSN result (the reference's quirk)
            residual = self.downsample(x)
        out = F.relu(residual + b)
        if self.pos == "post":
            out = cnsn(out)
        return out


class CifarResNeXt(nn.Module):
    """Images NHWC (B, 32, 32, 3) → logits (B, classes), in train or eval
    mode.  ``dtype`` is the compute type (None = fp32, or torch.bfloat16);
    parameters and statistics stay fp32.  ``generator`` seeds every
    initializer."""

    def __init__(self, depth: int = 29, cardinality: int = 4,
                 base_width: int = 32, num_classes: int = 10,
                 pos: str = "residual", crop: str = "neither",
                 beta: float = 1.0, cnsn_type: str = "cnsn",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (depth - 2) % 9:
            raise ValueError(f"depth {depth}: depth − 2 must divide by 9")
        g = generator or torch.Generator()
        blocks = (depth - 2) // 9
        self.cnsn_type = cnsn_type
        self.conv_1_3x3 = conv_he_fanout(3, 64, 3, dtype=dtype, generator=g)
        self.bn_1 = BatchNorm(64)
        inplanes = 64
        for s, planes in enumerate((64, 128, 256)):
            stage = []
            for i in range(blocks):
                stride = 1 if s == 0 or i else 2
                has_ds = i == 0 and (stride != 1 or inplanes != planes * 4)
                stage.append(ResNeXtBottleneck(
                    inplanes, planes, cardinality, base_width, pos,
                    cnsn_type, crop, beta, stride, has_ds, dtype, g))
                inplanes = planes * 4
            self.add_module(f"stage_{s + 1}", nn.Sequential(*stage))
        self.classifier = linear_kaiming_normal(inplanes, num_classes,
                                                dtype=dtype, generator=g)

    def _blocks(self):
        for stage in (self.stage_1, self.stage_2, self.stage_3):
            yield from stage

    @property
    def cn_num(self) -> int:
        """CrossNorm sites: one per bottleneck when ``cnsn_type`` has
        CrossNorm, else 0."""
        return len(list(self._blocks())) if "cn" in self.cnsn_type else 0

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                cn_draws: Optional[Sequence[dict]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``cn_active``: one host gate per bottleneck's CrossNorm site, or
        None (a plain forward); ``cn_draws``: each site's draws, or None to
        draw them from ``generator``."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        gates = site_gates(cn_active, len(list(self._blocks())))
        x = F.relu(self.bn_1(self.conv_1_3x3(images.permute(0, 3, 1, 2))))
        for site, block in enumerate(self._blocks()):
            x = block(x, gates[site],
                      None if cn_draws is None else cn_draws[site], generator)
        return self.classifier(x.mean(dim=(2, 3)))


def resnext29(num_classes: int = 10, cardinality: int = 4,
              base_width: int = 32, **kw) -> CifarResNeXt:
    """ResNeXt-29 (4×32d by default), the registry's
    (``cnsn_tpu/models/resnext.py:131-135``)."""
    return CifarResNeXt(depth=29, cardinality=cardinality,
                        base_width=base_width, num_classes=num_classes, **kw)
