"""CrossNorm / SelfNorm / CNSN: port of ``cnsn_tpu/nn/cnsn.py``.

Activations are NCHW tensors in ``torch.channels_last`` memory.  Eval
SelfNorm folds its BatchNorm1d running statistics into an affine and runs
the fused K3 op (``ops/kernels/selfnorm.py``); train SelfNorm takes its
instance statistics through K1 (``ops/stats.py``).  An inactive CrossNorm
is the identity; an active in-network site and the fused CNSN path are not
ported yet.  Parameter names follow the reference torch modules
(``selfnorm.g_fc.weight`` of shape (C, 1, 2), ``selfnorm.g_bn.*``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.kernels.selfnorm import selfnorm_infer
from ..ops.stats import instance_mean_std
from .norm import BatchNorm1dStats

__all__ = ["CrossNorm", "SelfNorm", "CNSN"]


class CrossNorm(nn.Module):
    """One CrossNorm site (``crop`` region mode, ``beta`` of its bbox
    draw).  ``active is None`` (eval, plain forward) is the identity; an
    active site is not ported yet and raises."""

    def __init__(self, crop: str = "neither", beta: float = 1.0):
        super().__init__()
        self.crop, self.beta = crop, beta

    def forward(self, x: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        if active is None:
            return x
        raise NotImplementedError(
            "an active in-network CrossNorm site is not ported yet (ROADMAP "
            "queue 1: in-network CrossNorm and the fused CNSN path)")


class _PairFC(nn.Module):
    """The reference's per-channel 2→1 FC, Conv1d(C, C, 2, groups=C,
    bias=False): ``weight`` (C, 1, 2), torch's default init
    U(±sqrt(1/2)) (fan_in = 2)."""

    def __init__(self, features: int, generator: torch.Generator):
        super().__init__()
        bound = 0.5 ** 0.5
        self.weight = nn.Parameter(torch.empty(features, 1, 2).uniform_(
            -bound, bound, generator=generator))


class SelfNorm(nn.Module):
    """SelfNorm: g = sigmoid(BN1d(w0·mean + w1·std)), out = x·g, with the
    instance statistics taken at eps 1e-12, ddof 1.

    Each mode rounds as its JAX path does.  Train (``cnsn_tpu/nn/cnsn.py:
    126-149``): the statistics are cast to x's type, the FC and BN1d run
    in fp32, g is cast to x's type and x·g is taken in x's type.  Eval
    (K3, the Pallas kernel's rounding): x·g in fp32, cast once.
    """

    def __init__(self, features: int, is_two: bool = False,
                 eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if is_two:
            raise NotImplementedError("SelfNorm is_two=True (the mean "
                                      "recalibration branch) is not ported")
        self.features = features
        self.eps = eps
        self.g_fc = _PairFC(features, generator or torch.Generator())
        self.g_bn = BatchNorm1dStats(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.g_fc.weight.reshape(self.features, 2)
        if not self.training:
            a, b = self.g_bn.folded_affine()
            out = selfnorm_infer(x.permute(0, 2, 3, 1), w, a, b, self.eps)
            return out.permute(0, 3, 1, 2)
        n, c = x.shape[0], self.features
        mean, std = instance_mean_std(x.permute(0, 2, 3, 1), eps=self.eps)
        sdt = torch.promote_types(x.dtype, torch.float32)
        y = (mean.reshape(n, c).to(sdt) * w[:, 0]
             + std.reshape(n, c).to(sdt) * w[:, 1])
        g = torch.sigmoid(self.g_bn(y)).to(x.dtype)
        return x * g.reshape(n, c, 1, 1)


class CNSN(nn.Module):
    """CrossNorm-then-SelfNorm composition for ``cnsn_type`` in
    {'cn', 'sn', 'cnsn'}."""

    def __init__(self, features: int, cnsn_type: str, crop: str = "neither",
                 beta: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cnsn_type not in ("cn", "sn", "cnsn"):
            raise ValueError(f"bad cnsn_type {cnsn_type!r}")
        self.crossnorm = (CrossNorm(crop, beta)
                          if "cn" in cnsn_type else None)
        self.selfnorm = (SelfNorm(features, generator=generator)
                         if "sn" in cnsn_type else None)

    def forward(self, x: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.crossnorm is not None:
            x = self.crossnorm(x, active)
        if self.selfnorm is not None:
            x = self.selfnorm(x)
        return x
