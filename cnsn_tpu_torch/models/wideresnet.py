"""CIFAR WideResNet with CNSN, train and eval forward: port of
``cnsn_tpu/models/wideresnet.py``.

Pre-activation basic blocks, CNSN at one of {residual, identity, pre,
post} per block, ``pre`` with unequal in/out channels sizing its SelfNorm
to ``in_planes`` (``:43-44``); one CNSN site per block, 18 at depth 40.
The public input is NHWC (B, H, W, 3), as in the JAX package.  Module
names follow the reference torch state dict (``block1.layer.0.conv1``,
``block1.layer.0.conv_shortcut``, ``bn1``, ``fc``), which
``cnsn_tpu/utils/torch_import.py::_translate`` maps onto JAX's
``block1_0/conv1``.  Every 3×3 conv comes from ``conv_he_fanout``, so
``CNSN_CONV3X3=pallas`` sends the 35 stride-1 ones of WRN-40-2 to K4.
Dropout (``drop_rate`` > 0) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cnsn import CNSN
from ..nn.norm import BatchNorm
from .common import Linear, conv_he_fanout

__all__ = ["BasicBlock", "WideResNet"]

_POSITIONS = ("residual", "identity", "pre", "post")


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 pos: str, cnsn_type: str, crop: str = "neither",
                 beta: float = 1.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos not in _POSITIONS:
            raise ValueError(f"bad pos {pos!r}: one of {_POSITIONS}")
        g = generator or torch.Generator()
        self.pos = pos
        self.equal = in_planes == out_planes
        sn_feats = in_planes if pos == "pre" and not self.equal else out_planes
        self.cnsn = CNSN(sn_feats, cnsn_type, crop=crop, beta=beta,
                         generator=g)
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = conv_he_fanout(in_planes, out_planes, 3, stride,
                                    dtype=dtype, generator=g)
        self.bn2 = BatchNorm(out_planes)
        self.conv2 = conv_he_fanout(out_planes, out_planes, 3, dtype=dtype,
                                    generator=g)
        self.conv_shortcut = None
        if not self.equal:
            self.conv_shortcut = conv_he_fanout(in_planes, out_planes, 1,
                                                stride, dtype=dtype,
                                                generator=g)

    def forward(self, x: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.equal:
            x = F.relu(self.bn1(x))
        out = self.cnsn(x, active) if self.pos == "pre" else x
        if self.equal:
            out = F.relu(self.bn1(out))
        out = F.relu(self.bn2(self.conv1(out)))
        out = self.conv2(out)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        if self.pos == "residual":
            out = self.cnsn(out, active)
        elif self.pos == "identity":
            x = self.cnsn(x, active)
        out = x + out
        if self.pos == "post":
            out = self.cnsn(out, active)
        return out


class _Group(nn.Module):
    """The reference's NetworkBlock: its blocks under ``layer``."""

    def __init__(self, blocks):
        super().__init__()
        self.layer = nn.Sequential(*blocks)


class WideResNet(nn.Module):
    """WRN-depth-k: images NHWC (B, H, W, 3) → logits (B, classes), in
    train or eval mode.  ``dtype`` is the compute type (None = fp32, or
    torch.bfloat16); parameters and statistics stay fp32.  ``generator``
    seeds every initializer."""

    def __init__(self, depth: int = 40, num_classes: int = 10,
                 widen_factor: int = 2, pos: str = "residual",
                 crop: str = "neither", beta: float = 1.0,
                 cnsn_type: str = "cnsn",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"depth {depth}: depth − 4 must divide by 6")
        g = generator or torch.Generator()
        n = (depth - 4) // 6
        chans = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.cnsn_type = cnsn_type
        self.conv1 = conv_he_fanout(3, chans[0], 3, dtype=dtype, generator=g)
        for grp in range(3):
            self.add_module(f"block{grp + 1}", _Group(
                BasicBlock(chans[grp] if i == 0 else chans[grp + 1],
                           chans[grp + 1], 1 if i or grp == 0 else 2, pos,
                           cnsn_type, crop, beta, dtype, g)
                for i in range(n)))
        self.bn1 = BatchNorm(chans[3])
        self.fc = Linear(chans[3], num_classes, dtype=dtype, generator=g)

    def _blocks(self):
        for grp in (self.block1, self.block2, self.block3):
            yield from grp.layer

    @property
    def cn_num(self) -> int:
        """CrossNorm sites: one per block when ``cnsn_type`` has CrossNorm
        (``:89-92``), else 0."""
        return len(list(self._blocks())) if "cn" in self.cnsn_type else 0

    def forward(self, images: torch.Tensor,
                cn_active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cn_active``: (cn_num,) bool, one gate per block's CrossNorm
        site, or None (no site active)."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        out = self.conv1(images.permute(0, 3, 1, 2))
        for site, block in enumerate(self._blocks()):
            out = block(out, None if cn_active is None else cn_active[site])
        out = F.relu(self.bn1(out))
        return self.fc(out.mean(dim=(2, 3)))
