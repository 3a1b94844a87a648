"""ResNet-50-IBN-a and -b with CNSN, train and eval forward: port of
``cnsn_tpu/models/resnet_ibn.py`` (reference:
models/imagenet/resnet_ibn_cnsn.py:24-315).

  * IBN-a: ``bn1`` of every bottleneck in an 'a' stage is an ``IBN``
    (InstanceNorm on half the channels, BatchNorm on the rest);
    ibn_cfg ('a', 'a', 'a', None).
  * IBN-b: an affine ``InstanceNorm`` (``IN``) after the residual add of
    the last block of each 'b' stage, and the stem's ``bn1``; those
    blocks skip their CNSN at pos 'post', so the CNSN sites (and
    ``cn_num``) are the blocks that keep one; ibn_cfg ('b', 'b', None,
    None).
  * At pos 'pre' the downsample branch takes the CNSN's output, as the
    conv branch does (ResNet-50's takes the block's input).
  * ``remat`` rematerialises every bottleneck in training
    (``models/remat.py``; JAX ``resnet_ibn.py:100,142``).

The stem is the plain 7×7/s2 conv, as the port's ResNet-50 has it
(``models/common.py``).  The public input is NHWC (B, H, W, 3); inside,
an NCHW view in ``torch.channels_last`` memory.  Module names follow the
reference torch state dict (``layer1.0.bn1.IN``, ``layer1.2.IN``, ``bn1``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cnsn import CNSN
from ..nn.norm import IBN, BatchNorm, InstanceNorm
from .common import Linear, conv_he_fanout, site_gates
from .remat import block_call
from .resnet import _POSITIONS, block_plan

__all__ = ["BottleneckIBN", "ResNetIBN", "resnet50_ibn_a", "resnet50_ibn_b"]


def block_ibn(stage_ibn: Optional[str], i: int, blocks: int
              ) -> Optional[str]:
    """A block's ibn flag: a 'b' stage puts IN on its last block only
    (reference resnet_ibn_cnsn.py:209-218)."""
    if stage_ibn == "b":
        return "b" if i == blocks - 1 else None
    return stage_ibn


class BottleneckIBN(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, pos: Optional[str],
                 cnsn_type: Optional[str], crop: str = "neither",
                 beta: float = 1.0, ibn: Optional[str] = None,
                 stride: int = 1, has_downsample: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        out_ch = planes * self.expansion
        self.pos = pos
        self.cnsn = None
        if cnsn_type is not None and not (ibn == "b" and pos == "post"):
            if pos not in _POSITIONS:
                raise ValueError(f"bad pos {pos!r}: one of {_POSITIONS}")
            sn_feats = inplanes if pos == "pre" else out_ch
            self.cnsn = CNSN(sn_feats, cnsn_type, crop=crop, beta=beta,
                             generator=g)
        self.conv1 = conv_he_fanout(inplanes, planes, 1, dtype=dtype,
                                    generator=g)
        self.bn1 = IBN(planes) if ibn == "a" else BatchNorm(planes)
        self.conv2 = conv_he_fanout(planes, planes, 3, stride, dtype=dtype,
                                    generator=g)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv_he_fanout(planes, out_ch, 1, dtype=dtype,
                                    generator=g)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                conv_he_fanout(inplanes, out_ch, 1, stride, dtype=dtype,
                               generator=g),
                BatchNorm(out_ch))
        self.IN = InstanceNorm(out_ch) if ibn == "b" else None

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``active``, ``draws`` and ``generator``: the block's CrossNorm
        gate and draws, as ``models/resnet.py::Bottleneck`` takes them."""
        def cnsn(t):
            return self.cnsn(t, active, draws, generator)

        identity = x
        if self.cnsn is not None and self.pos == "pre":
            # the downsample sees the CNSN's output too, unlike ResNet's
            # bottleneck (cnsn_tpu/models/resnet_ibn.py:55-57, 71-72)
            x = cnsn(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        if self.cnsn is not None:
            if self.pos == "residual":
                out = cnsn(out)
            elif self.pos == "identity":
                identity = cnsn(identity)
        out = out + identity
        if self.IN is not None:
            out = self.IN(out)
        elif self.cnsn is not None and self.pos == "post":
            out = cnsn(out)
        return F.relu(out)


class ResNetIBN(nn.Module):
    """ResNet-IBN: images NHWC (B, H, W, 3) → logits (B, classes), in
    train or eval mode; ``dtype``, ``remat`` and ``generator`` as
    ``ResNet``'s."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 ibn_cfg: Sequence[Optional[str]] = ("a", "a", "a", None),
                 num_classes: int = 1000, pos: Optional[str] = None,
                 crop: str = "neither", beta: float = 1.0,
                 cnsn_type: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        self.cnsn_type = cnsn_type
        self.remat = bool(remat)
        self.ibn_cfg = tuple(ibn_cfg)
        self.conv1 = conv_he_fanout(3, 64, 7, 2, dtype=dtype, generator=g)
        self.bn1 = (InstanceNorm(64) if self.ibn_cfg[0] == "b"
                    else BatchNorm(64))
        stages = [[] for _ in range(4)]
        for blk in block_plan(layers):
            s = blk["stage"] - 1
            stages[s].append(BottleneckIBN(
                blk["inplanes"], blk["planes"], pos=pos, cnsn_type=cnsn_type,
                crop=crop, beta=beta,
                ibn=block_ibn(self.ibn_cfg[s], len(stages[s]), layers[s]),
                stride=blk["stride"], has_downsample=blk["has_downsample"],
                dtype=dtype, generator=g))
        self.layer1, self.layer2, self.layer3, self.layer4 = (
            nn.Sequential(*blocks) for blocks in stages)
        self.fc = Linear(512 * BottleneckIBN.expansion, num_classes,
                         dtype=dtype, generator=g)

    def _sites(self):
        """The blocks that keep a CNSN site, in forward order."""
        return [b for layer in (self.layer1, self.layer2, self.layer3,
                                self.layer4) for b in layer
                if b.cnsn is not None]

    @property
    def cn_num(self) -> int:
        """In-network CrossNorm sites: the blocks that keep a CNSN, when
        ``cnsn_type`` has CrossNorm, else 0."""
        if self.cnsn_type is not None and "cn" in self.cnsn_type:
            return len(self._sites())
        return 0

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                cn_draws: Optional[Sequence[dict]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``cn_active``: one host gate per CNSN site (the blocks that keep
        one), or None; ``cn_draws``: each site's draws, or None."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        gates = site_gates(cn_active, len(self._sites()))
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        site = 0
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                if block.cnsn is None:
                    x = block_call(block, self.remat, x)
                    continue
                x = block_call(block, self.remat, x, gates[site],
                               None if cn_draws is None else cn_draws[site],
                               generator)
                site += 1
        return self.fc(x.mean(dim=(2, 3)))


def resnet50_ibn_a(num_classes: int = 1000,
                   layers: Sequence[int] = (3, 4, 6, 3), **kw) -> ResNetIBN:
    """ResNet-50-IBN-a (reference resnet_ibn_cnsn.py:252-267); ``layers``
    cuts its depth for tests."""
    return ResNetIBN(layers=layers, ibn_cfg=("a", "a", "a", None),
                     num_classes=num_classes, **kw)


def resnet50_ibn_b(num_classes: int = 1000,
                   layers: Sequence[int] = (3, 4, 6, 3), **kw) -> ResNetIBN:
    """ResNet-50-IBN-b (reference resnet_ibn_cnsn.py:297-313); ``layers``
    cuts its depth for tests."""
    return ResNetIBN(layers=layers, ibn_cfg=("b", "b", None, None),
                     num_classes=num_classes, **kw)
