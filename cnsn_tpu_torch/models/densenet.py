"""DenseNet-40-12 with CNSN (no bottleneck, reduction 1.0), train and eval
forward: port of ``cnsn_tpu/models/densenet.py``.

Dense layers BN → ReLU → 3×3 conv → concatenation, with the CNSN at
'conv1_pre' (on the layer's input, which is then concatenated) or
'conv1_post' (on the conv's 12 new channels); 3 dense blocks of
(depth − 4)/3 layers, 36 CNSN sites at depth 40; transitions BN → ReLU →
1×1 conv → 2×2 average pool.  The channel count grows 24 + 12k, so half
of the sites and BatchNorms see C ≡ 4 (mod 8).  The concatenation is
taken on the NHWC views, so every activation stays channels_last and
the kernels receive NHWC-contiguous tensors.

The registry's factory fixes ``bottleneck=False`` and reduction 1.0
(``cnsn_tpu/models/densenet.py:140-143``), so the JAX package's
``BottleneckLayer`` and ``reduction`` are not ported.  Module names follow
the reference torch state dict (``dense1.0.conv1``, ``trans1.bn1``,
``trans1.conv1``, ``bn1``, ``fc``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.cnsn import CNSN
from ..nn.norm import BatchNorm
from .common import Linear, conv_he_fanout, site_gates

__all__ = ["DenseNet", "densenet"]

_POSITIONS = ("conv1_pre", "conv1_post")


def _cat(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """torch.cat along channels of two channels_last NCHW tensors, taken on
    their NHWC views: the result is channels_last."""
    return torch.cat([x.permute(0, 2, 3, 1), out.permute(0, 2, 3, 1)],
                     dim=3).permute(0, 3, 1, 2)


class DenseLayer(nn.Module):
    """The reference's SingleLayerCustom: x ‖ conv1(relu(bn1(x)))."""

    def __init__(self, n_channels: int, growth_rate: int, pos: str,
                 cnsn_type: str, crop: str = "neither", beta: float = 1.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos not in _POSITIONS:
            raise ValueError(f"bad pos {pos!r}: one of {_POSITIONS}")
        g = generator or torch.Generator()
        self.pos = pos
        feats = n_channels if pos == "conv1_pre" else growth_rate
        self.cnsn = CNSN(feats, cnsn_type, crop=crop, beta=beta, generator=g)
        self.bn1 = BatchNorm(n_channels)
        self.conv1 = conv_he_fanout(n_channels, growth_rate, 3, dtype=dtype,
                                    generator=g)

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.pos == "conv1_pre":
            x = self.cnsn(x, active, draws, generator)
        out = self.conv1(F.relu(self.bn1(x)))
        if self.pos == "conv1_post":
            out = self.cnsn(out, active, draws, generator)
        return _cat(x, out)


class Transition(nn.Module):
    def __init__(self, n_channels: int, n_out: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bn1 = BatchNorm(n_channels)
        self.conv1 = conv_he_fanout(n_channels, n_out, 1, dtype=dtype,
                                    generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv1(F.relu(self.bn1(x))), 2)


class DenseNet(nn.Module):
    """Images NHWC (B, 32, 32, 3) → logits (B, classes), in train or eval
    mode.  ``dtype`` is the compute type (None = fp32, or torch.bfloat16);
    parameters and statistics stay fp32.  ``generator`` seeds every
    initializer."""

    def __init__(self, growth_rate: int = 12, depth: int = 40,
                 num_classes: int = 10, pos: str = "conv1_pre",
                 crop: str = "neither", beta: float = 1.0,
                 cnsn_type: str = "cnsn",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        self.cnsn_type = cnsn_type
        nd = int((depth - 4) / 3)
        n_ch = 2 * growth_rate
        self.conv1 = conv_he_fanout(3, n_ch, 3, dtype=dtype, generator=g)
        for b in range(3):
            layers = []
            for _ in range(nd):
                layers.append(DenseLayer(n_ch, growth_rate, pos, cnsn_type,
                                         crop, beta, dtype, g))
                n_ch += growth_rate
            self.add_module(f"dense{b + 1}", nn.Sequential(*layers))
            if b < 2:
                self.add_module(f"trans{b + 1}",
                                Transition(n_ch, n_ch, dtype, g))
        self.bn1 = BatchNorm(n_ch)
        self.fc = Linear(n_ch, num_classes, dtype=dtype, generator=g)

    def _layers(self):
        for blk in (self.dense1, self.dense2, self.dense3):
            yield from blk

    @property
    def cn_num(self) -> int:
        """CrossNorm sites: one per dense layer when ``cnsn_type`` has
        CrossNorm, else 0."""
        return len(list(self._layers())) if "cn" in self.cnsn_type else 0

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                cn_draws: Optional[Sequence[dict]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``cn_active``: one host gate per dense layer's CrossNorm site, or
        None (a plain forward); ``cn_draws``: each site's draws, or None to
        draw them from ``generator``."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        gates = site_gates(cn_active, len(list(self._layers())))
        x = self.conv1(images.permute(0, 3, 1, 2))
        site = 0
        for b, blk in enumerate((self.dense1, self.dense2, self.dense3)):
            for layer in blk:
                x = layer(x, gates[site],
                          None if cn_draws is None else cn_draws[site],
                          generator)
                site += 1
            if b < 2:
                x = getattr(self, f"trans{b + 1}")(x)
        x = F.relu(self.bn1(x))
        return self.fc(x.mean(dim=(2, 3)))


def densenet(num_classes: int = 10, **kw) -> DenseNet:
    """DenseNet-40-12, the registry's (``cnsn_tpu/models/densenet.py:
    140-143``)."""
    return DenseNet(growth_rate=12, depth=40, num_classes=num_classes, **kw)
