"""ImageNet ResNet-50 (v1.5) with CNSN, train and eval forward: port of
``cnsn_tpu/models/resnet.py``.

Stride on the 3×3 conv (v1.5), CNSN at {residual, pre, post, identity}
per bottleneck, ``cnsn_type=None`` for the plain bottleneck; 16
bottleneck sites; global average pool head.  ``remat`` rematerialises
each bottleneck in training (``models/remat.py``), as the JAX model's
``remat`` (``cnsn_tpu/models/resnet.py:116,143``).  The public input is
NHWC (B, H, W, 3), as in the JAX package; inside, it becomes an NCHW view
in ``torch.channels_last`` memory (zero-copy from NHWC-contiguous data).
Module names follow the reference torch state dict (``layer1.0.conv1``,
``layer1.0.downsample.0``, ``layer1.0.cnsn.selfnorm.g_fc``, ``fc``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cnsn import CNSN
from ..nn.norm import BatchNorm
from .common import Linear, conv_he_fanout, site_gates
from .remat import block_call

__all__ = ["Bottleneck", "ResNet", "block_plan", "resnet50"]

_POSITIONS = ("residual", "pre", "post", "identity")


def block_plan(layers: Sequence[int]):
    """Static per-bottleneck construction plan, stage by stage: the same
    blocks, strides and downsample flags as the JAX ``block_plan``."""
    plan = []
    inplanes = 64
    for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride = 1 if s == 0 else 2
        for i in range(blocks):
            blk_stride = stride if i == 0 else 1
            has_ds = (i == 0) and (blk_stride != 1 or inplanes != planes * 4)
            plan.append(dict(stage=s + 1, inplanes=inplanes,
                             planes=planes, stride=blk_stride,
                             has_downsample=has_ds))
            inplanes = planes * 4
    return plan


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, pos: Optional[str],
                 cnsn_type: Optional[str], crop: str = "neither",
                 beta: float = 1.0, stride: int = 1,
                 has_downsample: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        out_ch = planes * self.expansion
        self.pos = pos
        self.cnsn = None
        if cnsn_type is not None:
            if pos not in _POSITIONS:
                raise ValueError(f"bad pos {pos!r}: one of {_POSITIONS}")
            sn_feats = inplanes if pos == "pre" else out_ch
            self.cnsn = CNSN(sn_feats, cnsn_type, crop=crop, beta=beta,
                             generator=g)
        self.conv1 = conv_he_fanout(inplanes, planes, 1, dtype=dtype,
                                    generator=g)
        self.bn1 = BatchNorm(planes)
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

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``active``: the block's CrossNorm gate (None: no CrossNorm
        forward); ``draws`` and ``generator``: its random draws
        (``nn/cnsn.py::CrossNorm``)."""
        def cnsn(t):
            return self.cnsn(t, active, draws, generator)

        identity = x
        out = x
        if self.cnsn is not None and self.pos == "pre":
            out = cnsn(out)
        out = F.relu(self.bn1(self.conv1(out)))
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
        if self.cnsn is not None and self.pos == "post":
            out = cnsn(out)
        return F.relu(out)


class ResNet(nn.Module):
    """ResNet: images NHWC (B, H, W, 3) → logits (B, classes), in train
    mode (batch statistics, running statistics updated) or eval mode.

    ``dtype`` is the compute type (None = fp32, or torch.bfloat16);
    parameters and statistics stay fp32, and autograd carries each
    gradient back to the fp32 parameter through its cast.  ``generator``
    seeds every initializer (a fresh default generator when None).
    ``remat`` rematerialises every bottleneck in training.
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, pos: Optional[str] = None,
                 crop: str = "neither", beta: float = 1.0,
                 cnsn_type: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        self.cnsn_type = cnsn_type
        self.remat = bool(remat)
        self.conv1 = conv_he_fanout(3, 64, 7, 2, dtype=dtype, generator=g)
        self.bn1 = BatchNorm(64)
        stages = [[] for _ in range(4)]
        for blk in block_plan(layers):
            stages[blk["stage"] - 1].append(Bottleneck(
                blk["inplanes"], blk["planes"], pos=pos, cnsn_type=cnsn_type,
                crop=crop, beta=beta, stride=blk["stride"],
                has_downsample=blk["has_downsample"], dtype=dtype,
                generator=g))
        self.layer1, self.layer2, self.layer3, self.layer4 = (
            nn.Sequential(*blocks) for blocks in stages)
        self.fc = Linear(512 * Bottleneck.expansion, num_classes, dtype=dtype,
                         generator=g)

    @property
    def cn_num(self) -> int:
        """In-network CrossNorm sites: one per bottleneck when
        ``cnsn_type`` has CrossNorm, else 0."""
        if self.cnsn_type is not None and "cn" in self.cnsn_type:
            return sum(len(layer) for layer in self._stages())
        return 0

    def _stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                cn_draws: Optional[Sequence[dict]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``cn_active``: one host gate per bottleneck's CrossNorm site
        (cn_num bools, or a CPU bool tensor), or None (a plain forward);
        ``cn_draws``: each site's draws, or None to draw them all from
        ``generator``."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        gates = site_gates(cn_active,
                           sum(len(layer) for layer in self._stages()))
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # implicit -inf padding, as flax's
        site = 0
        for layer in self._stages():
            for block in layer:
                x = block_call(block, self.remat, x, gates[site],
                               None if cn_draws is None else cn_draws[site],
                               generator)
                site += 1
        return self.fc(x.mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000, layers: Sequence[int] = (3, 4, 6, 3),
             **kw) -> ResNet:
    """ResNet-50; ``layers`` cuts its depth (blocks per stage) for tests."""
    return ResNet(layers=layers, num_classes=num_classes, **kw)
