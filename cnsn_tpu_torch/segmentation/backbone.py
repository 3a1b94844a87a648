"""Segmentation backbone: dilated ResNet-50 with stage-selectable CNSN,
port of ``cnsn_tpu/segmentation/backbone.py`` (reference
segmentation/model/cnsn_resnet.py:215-472).

  * v1.5 bottlenecks with ``replace_stride_with_dilation=[False, True,
    True]``: output stride 8, layer3 dilated 2, layer4 dilated 4; in
    'torchvision' mode the first block of a dilated stage keeps the
    previous dilation on its 3×3, in 'psp' mode every 3×3 of the stage
    takes the full dilation;
  * ``block_idxs`` ('1_2_3_4') selects the stages with CNSN blocks; ``0``
    adds an image-level CrossNorm before the stem (``img_cn``), gated on
    its own;
  * ``cn_pos`` ('post') places a separate CrossNorm (the reference's
    ``real_cn``) after the block, and the CNSN slot at ``pos`` then
    carries SelfNorm only;
  * ``remat`` (True, False or a stage spec: '1_2', or the int 12 an
    unquoted YAML ``1_2`` parses to) rematerialises the bottlenecks of the
    listed stages in training (``models/remat.py::remat_stages``, JAX's
    ``remat_stages``);
  * returns {'out': layer4, 'aux': layer3}, NHWC views.

The convolutions are plain (dilated) convolutions, as the JAX backbone's
``nn.Conv``; BatchNorm trains through K2 (``nn/norm.py``), SelfNorm
through K1 in training and K3 in eval (``nn/cnsn.py``), and CrossNorm at
crop 'style' takes its content statistics through K1 and its style box's
in plain torch (``ops/crossnorm.py``).  Module names follow the reference
torch state dict (``layer1.0.conv1``, ``layer1.0.downsample.0``,
``layer1.0.cnsn.selfnorm.g_fc``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import Conv2d, site_gates
from ..models.remat import block_call, remat_stages
from ..nn.cnsn import CNSN, CrossNorm
from ..nn.norm import BatchNorm

__all__ = ["SegBottleneck", "SegResNet", "seg_resnet50"]

_POSITIONS = ("residual", "identity", "pre", "post")


class DilatedConv(Conv2d):
    """A bias-free He(fan_out) ``Conv2d`` with ``dilation`` and padding
    dilation·(k//2) (the JAX backbone's ``_conv``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel, stride, dtype, generator,
                         padding=dilation * (kernel // 2))
        self.dilation = dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding, self.dilation)

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, dilation={self.dilation}"


class SegBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 custom: bool = False, pos: Optional[str] = None,
                 cn_pos: Optional[str] = None,
                 cnsn_type: Optional[str] = None, crop: str = "neither",
                 beta: float = 1.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        out_ch = planes * self.expansion
        self.pos, self.cn_pos = pos, cn_pos
        self.cnsn = self.real_cn = None
        if custom:
            if cnsn_type not in ("sn", "cn", "cnsn"):
                raise ValueError(f"bad cnsn_type {cnsn_type!r}")
            if pos not in _POSITIONS:
                raise ValueError(f"bad pos {pos!r}: one of {_POSITIONS}")
            if cn_pos is not None:
                # decoupled sites: CrossNorm at cn_pos, SelfNorm (if any)
                # in the CNSN slot at pos
                if "cn" in cnsn_type:
                    self.real_cn = CrossNorm(crop, beta)
                slot = "sn" if "sn" in cnsn_type else None
            else:
                slot = cnsn_type
            if slot is not None:
                feats = (inplanes if pos == "pre" and not has_downsample
                         else out_ch)
                self.cnsn = CNSN(feats, slot, crop=crop, beta=beta,
                                 generator=g)
        self.conv1 = DilatedConv(inplanes, planes, 1, dtype=dtype,
                                 generator=g)
        self.bn1 = BatchNorm(planes)
        self.conv2 = DilatedConv(planes, planes, 3, stride, dilation,
                                 dtype=dtype, generator=g)
        self.bn2 = BatchNorm(planes)
        self.conv3 = DilatedConv(planes, out_ch, 1, dtype=dtype, generator=g)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                DilatedConv(inplanes, out_ch, 1, stride, dtype=dtype,
                            generator=g),
                BatchNorm(out_ch))

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``active``: the block's CrossNorm gate (None: no CrossNorm
        forward); ``draws`` and ``generator``: its random draws."""
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
        out = F.relu(out + identity)
        if self.cnsn is not None and self.pos == "post":
            out = cnsn(out)
        if self.real_cn is not None and self.cn_pos == "post":
            out = self.real_cn(out, active, draws, generator)
        return out


class SegResNet(nn.Module):
    """Dilated CNSN ResNet: NHWC images (B, H, W, 3) → {'out', 'aux'}
    NHWC features at stride 8, in train or eval mode.  ``dtype`` is the
    compute type (None = fp32, or torch.bfloat16); parameters and
    statistics stay fp32.  ``generator`` seeds every initializer."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 block_idxs: str = "1_2_3_4",
                 pos: Optional[str] = "residual",
                 cn_pos: Optional[str] = "post",
                 cnsn_type: Optional[str] = "cnsn", crop: str = "style",
                 beta: float = 1.0, dtype: Optional[torch.dtype] = None,
                 remat: Any = False, dilation_mode: str = "torchvision",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dilation_mode not in ("torchvision", "psp"):
            raise ValueError(f"bad dilation_mode {dilation_mode!r}")
        g = generator or torch.Generator()
        self.layers = tuple(layers)
        self.block_idxs = block_idxs
        self.cnsn_type = cnsn_type
        self.remat = remat
        self.remat_stages = remat_stages(remat)
        self.img_cn = (CrossNorm(crop, beta) if self.has_img_cn else None)
        self.conv1 = DilatedConv(3, 64, 7, 2, dtype=dtype, generator=g)
        self.bn1 = BatchNorm(64)
        dilations, strides = (1, 1, 2, 4), (1, 2, 1, 1)
        inplanes = 64
        self.custom = []
        for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 self.layers)):
            custom = (s + 1) in self.idxs and cnsn_type is not None
            self.custom.append(custom)
            stage = []
            for i in range(blocks):
                has_ds = i == 0 and (strides[s] != 1 or inplanes != planes * 4)
                dil = (dilations[s - 1]
                       if (i == 0 and s > 0 and dilations[s] > 1
                           and dilation_mode != "psp")
                       else dilations[s])
                stage.append(SegBottleneck(
                    inplanes, planes, stride=strides[s] if i == 0 else 1,
                    dilation=dil, has_downsample=has_ds, custom=custom,
                    pos=pos, cn_pos=cn_pos, cnsn_type=cnsn_type, crop=crop,
                    beta=beta, dtype=dtype, generator=g))
                inplanes = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*stage))

    @property
    def idxs(self):
        return ([int(v) for v in str(self.block_idxs).split("_")]
                if self.block_idxs else [])

    @property
    def has_img_cn(self) -> bool:
        return bool(0 in self.idxs and self.cnsn_type
                    and "cn" in self.cnsn_type)

    @property
    def cn_num(self) -> int:
        """In-network CrossNorm sites (img_cn is gated on its own)."""
        if not self.cnsn_type or "cn" not in self.cnsn_type:
            return 0
        return sum(b for i, b in zip((1, 2, 3, 4), self.layers)
                   if i in self.idxs)

    def _stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                img_cn_active: Optional[bool] = None,
                cn_draws: Optional[Sequence[dict]] = None,
                img_cn_draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """``cn_active``: one host gate per CrossNorm site (``cn_num``
        bools, or a CPU bool tensor) or None (a plain forward);
        ``img_cn_active``: the image CrossNorm's gate; ``cn_draws``,
        ``img_cn_draws``: the sites' draws, else drawn from
        ``generator``."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        if self.img_cn is not None:
            x = self.img_cn(x, img_cn_active, img_cn_draws, generator)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        has_cn = bool(self.cnsn_type and "cn" in self.cnsn_type)
        gates = site_gates(cn_active, self.cn_num)
        site, aux = 0, None
        for s, layer in enumerate(self._stages()):
            remat = (s + 1) in self.remat_stages
            for block in layer:
                active = draws = None
                if self.custom[s] and has_cn:
                    active = gates[site]
                    draws = None if cn_draws is None else cn_draws[site]
                    site += 1
                x = block_call(block, remat, x, active, draws, generator)
            if s == 2:
                aux = x
        return {"out": x.permute(0, 2, 3, 1), "aux": aux.permute(0, 2, 3, 1)}


def seg_resnet50(**kw) -> SegResNet:
    """reference segmentation/model/cnsn_resnet.py:509-517 factory."""
    return SegResNet(layers=(3, 4, 6, 3), **kw)
