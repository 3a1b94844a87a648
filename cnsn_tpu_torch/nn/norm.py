"""Normalization layers, eval mode: port of ``cnsn_tpu/nn/norm.py``.

``BatchNorm`` and ``BatchNorm1dStats`` keep the reference torch state-dict
names (``weight``, ``bias``, ``running_mean``, ``running_var``) with fp32
parameters and statistics.  This slice of the port serves: a forward in
training mode raises ``NotImplementedError`` (BN train mode is the next
slice, with its K2 kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "BatchNorm1dStats", "TRAINING_NOT_PORTED"]

TRAINING_NOT_PORTED = ("training mode is not ported yet: cnsn_tpu_torch "
                       "serves eval forwards only (ROADMAP queue 1, the "
                       "training slice)")


class _NormStats(nn.Module):
    """Affine parameters and running statistics of a torch BatchNorm."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def extra_repr(self) -> str:
        return f"{self.features}, eps={self.eps}"


class BatchNorm(_NormStats):
    """torch.nn.BatchNorm2d in eval over an NCHW (channels_last) tensor:
    normalise with the running statistics, computing in fp32 and casting
    back to the input's type (``cnsn_tpu/nn/norm.py:190-195``).

    ``F.batch_norm`` with fp32 statistics and a bf16 input computes in
    fp32 and writes bf16, in one pass and keeping the memory format.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BatchNorm1dStats(_NormStats):
    """torch.nn.BatchNorm1d in eval over (N, C) per-channel scalars: the
    BN inside SelfNorm (``cnsn_tpu/nn/norm.py:198-235``)."""

    def folded_affine(self):
        """``(a, b)`` with  BN(y) = a·y + b:  a = scale/sqrt(rv+eps),
        b = bias − a·rm (``cnsn_tpu/nn/cnsn.py:95-103``)."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - a * self.running_mean

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        yf = y.to(torch.promote_types(y.dtype, torch.float32))
        out = ((yf - self.running_mean) * torch.rsqrt(self.running_var
                                                      + self.eps)
               * self.weight + self.bias)
        return out.to(y.dtype)
