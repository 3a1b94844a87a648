"""Normalization layers: port of ``cnsn_tpu/nn/norm.py`` (``BatchNorm``,
``BatchNorm1dStats``), in train and eval mode.

Both keep the reference torch state-dict names (``weight``, ``bias``,
``running_mean``, ``running_var``) with fp32 parameters and statistics.
In training the running statistics are updated in place (momentum 0.1,
unbiased variance), where JAX returns them as a new ``batch_stats`` tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.bn_stats import BnSums

__all__ = ["BatchNorm", "BatchNorm1dStats"]

MOMENTUM = 0.1  # running ← (1−m)·running + m·batch, as torch's and JAX's


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """At least float32: bf16 is promoted, float64 is kept."""
    return torch.promote_types(x.dtype, torch.float32)


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

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor,
                        n: int) -> None:
        """running ← (1−m)·running + m·batch at m = ``MOMENTUM``, with the
        unbiased variance var·n/(n−1) (``cnsn_tpu/nn/norm.py:173-179``)."""
        m = MOMENTUM
        unbiased = var * (n / max(n - 1, 1))
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)


class BatchNorm(_NormStats):
    """torch.nn.BatchNorm2d over an NCHW (channels_last) tensor.

    Train: the shifted one-pass statistics of ``cnsn_tpu/nn/norm.py:
    141-164`` through K2 (``BnSums``): with m0 the running mean,
    s1 = Σ(x−m0), s2 = Σ(x−m0)² over (N, H, W), mean = m0 + s1/n and
    var = max(s2/n − (s1/n)², 0).  Eval: the running statistics.  Either
    way the output is computed in fp32 and cast to x's type (``:190-195``).

    ``groups`` > 1 (per-replica statistics), ``stats_sample`` (ghost-BN
    subsampling) and a ``var_impl`` other than 'shifted' are JAX options
    off the single-card flagship path; they are not ported and raise in
    training.
    """

    def __init__(self, features: int, eps: float = 1e-5, groups: int = 1,
                 stats_sample: int = 0, var_impl: str = "shifted"):
        super().__init__(features, eps)
        self.groups = groups
        self.stats_sample = stats_sample
        self.var_impl = var_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # F.batch_norm with fp32 statistics and a bf16 input computes
            # in fp32 and writes bf16, in one pass, keeping the layout
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.groups != 1 or self.stats_sample or self.var_impl != "shifted":
            raise NotImplementedError(
                "BatchNorm groups > 1, stats_sample and var_impl other than "
                "'shifted' are not ported yet (ROADMAP queue 1: BN groups "
                "and stats_sample)")
        n = x.numel() // self.features
        # the shift: a copy, since the running mean is updated in place
        # below while the backward still needs the value used here
        m0 = self.running_mean.clone()
        s1, s2 = BnSums.apply(x.permute(0, 2, 3, 1), m0)
        mean_d = s1 / n
        var = torch.clamp(s2 / n - mean_d.square(), min=0.0)
        mean = m0 + mean_d
        self._update_running(mean, var, n)
        shape = (1, self.features, 1, 1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = ((x.to(_stat_dtype(x)) - mean.reshape(shape))
               * inv.reshape(shape) + self.bias.reshape(shape))
        return out.to(x.dtype)


class BatchNorm1dStats(_NormStats):
    """torch.nn.BatchNorm1d over (N, C) per-channel scalars: the BN inside
    SelfNorm (``cnsn_tpu/nn/norm.py:198-235``).  Train: two-pass batch
    statistics in plain torch (the input is only (N, C))."""

    def folded_affine(self):
        """``(a, b)`` with  BN(y) = a·y + b:  a = scale/sqrt(rv+eps),
        b = bias − a·rm (``cnsn_tpu/nn/cnsn.py:95-103``)."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - a * self.running_mean

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        yf = y.to(_stat_dtype(y))
        if self.training:
            mean = yf.mean(dim=0)
            var = (yf - mean).square().mean(dim=0)
            self._update_running(mean, var, y.shape[0])
        else:
            mean, var = self.running_mean, self.running_var
        out = (yf - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return out.to(y.dtype)
