"""AllConvNet with CNSN, train and eval forward: port of
``cnsn_tpu/models/allconv.py``.

Layer config [96, 96, 96, 'Md', 192, 192, 192, 'Md', 'nopad', 'NIN',
'NIN', 'A']: each conv entry is [conv, BN, gelu_sig] with the CNSN spliced
at index ``pos`` ∈ {1, 2, 3}; 'Md' is a 2×2 max pool and Dropout(0.5);
'nopad' a 3×3 conv with padding 0, 'NIN' the reference's 1×1 conv **with
padding 1** (the plane grows by 2); 'A' an 8×8/8 average pool in floor
mode.  9 CNSN sites.  The convs carry a bias and are built directly, as
JAX builds ``nn.Conv``, so ``CNSN_CONV3X3`` never reaches them.

Module names follow the reference torch state dict: the flat
``features`` Sequential (``features.<i>.weight``, its indices shifting
with ``pos``) and ``classifier``; ``allconv_key_map(pos)`` maps them onto
JAX's ``conv_<li>``/``bn_<li>``/``cnsn_<li>``, as
``cnsn_tpu/utils/torch_import.py::allconv_key_map`` does.

Dropout in training keeps an element with probability 1 − ``drop_rate``
and scales it by 1/(1 − ``drop_rate``), as flax's ``nn.Dropout``: its
masks, NHWC bools one per 'Md', are passed in or drawn on the images'
device from that device's default generator.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..nn.cnsn import CNSN
from ..nn.norm import BatchNorm, gelu_sig
from ..parallel.distributed import local_rows
from .common import Conv2d, Linear, site_gates

__all__ = ["AllConvNet", "allconv_key_map"]

CFG = (96, 96, 96, "Md", 192, 192, 192, "Md", "nopad", "NIN", "NIN", "A")
SITES = sum(isinstance(v, int) or v in ("nopad", "NIN") for v in CFG)  # 9


def allconv_key_map(pos: int) -> Dict[str, str]:
    """Torch prefix ``features.<i>`` → JAX module name (``conv_<li>``,
    ``bn_<li>``, ``cnsn_<li>``) at CNSN position ``pos``: 4 Sequential
    entries per conv layer, 2 per 'Md' (pool, dropout), 1 for 'A'."""
    out: Dict[str, str] = {}
    seq = 0
    for li, v in enumerate(CFG):
        if v == "Md":
            seq += 2
        elif v == "A":
            seq += 1
        else:
            names = [f"conv_{li}", f"bn_{li}", None]
            names.insert(pos, f"cnsn_{li}")
            out.update({f"features.{seq + i}": n
                        for i, n in enumerate(names) if n is not None})
            seq += 4
    return out


class GeluSig(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_sig(x)


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)`` on an NCHW (channels_last) tensor, its
    mask NHWC."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        xh = x.permute(0, 2, 3, 1)
        # across ranks a given mask is the global batch's
        mask = local_rows(mask, x.shape[0])
        if mask is None:
            mask = torch.rand(xh.shape, device=x.device) < keep
        return torch.where(mask.to(x.device), xh / keep,
                           0.0).permute(0, 3, 1, 2)


class AllConvNet(nn.Module):
    """Images NHWC (B, 32, 32, 3) → logits (B, classes), in train or eval
    mode.  ``dtype`` is the compute type (None = fp32, or torch.bfloat16);
    parameters and statistics stay fp32.  ``generator`` seeds every
    initializer."""

    def __init__(self, num_classes: int = 10, pos: int = 1,
                 crop: str = "neither", beta: float = 1.0,
                 cnsn_type: str = "cn", drop_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        pos = int(pos)
        if pos not in (1, 2, 3):
            raise ValueError(f"bad pos {pos!r}: one of 1, 2, 3")
        g = generator or torch.Generator()
        self.cnsn_type = cnsn_type
        layers, in_ch = [], 3
        for v in CFG:
            if v == "Md":
                layers += [nn.MaxPool2d(2, 2), Dropout(drop_rate)]
                continue
            if v == "A":
                layers.append(nn.AvgPool2d(8, 8))
                continue
            kernel, padding, out_ch = {"NIN": (1, 1, in_ch),
                                       "nopad": (3, 0, in_ch)}.get(v, (3, 1, v))
            block = [Conv2d(in_ch, out_ch, kernel, dtype=dtype, generator=g,
                            padding=padding, bias=True),
                     BatchNorm(out_ch), GeluSig()]
            block.insert(pos, CNSN(out_ch, cnsn_type, crop=crop, beta=beta,
                                   generator=g))
            layers += block
            in_ch = out_ch
        self.features = nn.Sequential(*layers)
        self.classifier = Linear(in_ch, num_classes, dtype=dtype, generator=g)

    @property
    def cn_num(self) -> int:
        """CrossNorm sites: one per conv layer when ``cnsn_type`` has
        CrossNorm, else 0."""
        return SITES if "cn" in self.cnsn_type else 0

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                cn_draws: Optional[Sequence[dict]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``cn_active``: one host gate per conv layer's CrossNorm site, or
        None (a plain forward); ``cn_draws``: each site's draws, or None to
        draw them from ``generator``; ``dropout_masks``: the two dropout
        masks (NHWC bools), or None to draw them."""
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got "
                             f"{tuple(images.shape)}")
        gates = site_gates(cn_active, SITES)
        x = images.permute(0, 3, 1, 2)
        site = drop = 0
        for m in self.features:
            if isinstance(m, CNSN):
                x = m(x, gates[site],
                      None if cn_draws is None else cn_draws[site], generator)
                site += 1
            elif isinstance(m, Dropout):
                x = m(x, None if dropout_masks is None
                      else dropout_masks[drop])
                drop += 1
            else:
                x = m(x)
        return self.classifier(x.flatten(1))
