"""Normalization layers: port of ``cnsn_tpu/nn/norm.py`` (``BatchNorm``,
``BatchNorm1dStats``, ``InstanceNorm``, ``IBN``, ``gelu_sig``), in train
and eval mode.

They keep the reference torch state-dict names (``weight``, ``bias``,
``running_mean``, ``running_var``; IBN's ``IN`` and ``BN`` children) with
fp32 parameters and statistics.
In training the running statistics are updated in place (momentum 0.1,
unbiased variance), where JAX returns them as a new ``batch_stats`` tree.
Inside a rematerialised block's recomputation (``ops/recompute.py``) they
are left as the first run left them, and BatchNorm's K2 shift is the
first run's, as JAX's ``nn.remat`` recomputes from the same
``batch_stats``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.bn_stats import BnSums
from ..ops.recompute import recomputing, replayed
from ..parallel.distributed import (all_gather_rows, all_reduce_sum,
                                    global_rows, local_rows)

__all__ = ["BatchNorm", "BatchNorm1dStats", "IBN", "InstanceNorm",
           "gelu_sig"]

MOMENTUM = 0.1  # running ← (1−m)·running + m·batch, as torch's and JAX's


def gelu_sig(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid-approximated GELU, x·sigmoid(1.702·x): AllConvNet's
    activation (``cnsn_tpu/nn/norm.py:31``), in x's type."""
    return x * torch.sigmoid(1.702 * x)


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
        unbiased variance var·n/(n−1) (``cnsn_tpu/nn/norm.py:173-179``);
        none in a recomputation."""
        if recomputing():
            return
        m = MOMENTUM
        unbiased = var * (n / max(n - 1, 1))
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)


class BatchNorm(_NormStats):
    """torch.nn.BatchNorm2d over an NCHW (channels_last) tensor, with the
    JAX package's options (``cnsn_tpu/nn/norm.py:40-195``).

    Train, ``var_impl`` 'shifted' (the default): the shifted one-pass
    statistics of ``:141-164`` through K2 (``BnSums``): with m0 the running
    mean, s1 = Σ(x−m0), s2 = Σ(x−m0)² over (N, H, W), mean = m0 + s1/n and
    var = max(s2/n − (s1/n)², 0).  'two' is the centred two-pass variance
    and 'one' the naive E[x²] − E[x]², both in plain torch, as in JAX.
    ``stats_sample`` = s (0 < s < N) takes the statistics of the leading s
    rows only, n = s·H·W, and normalizes every row with them (ghost BN);
    in channels_last those rows are one contiguous block, which K2 reads
    as it is.  ``groups`` = g > 1 with N divisible by g normalizes each
    contiguous block of N/g rows with its own two-pass statistics (the
    per-replica BN of data parallelism; ``var_impl`` and ``stats_sample``
    do not apply), the running statistics following group 0 with its
    count in the unbiased correction; where g does not divide N the
    whole batch is taken as one.  Eval: the running statistics.  Either
    way the output is computed in at least fp32 and cast to x's type
    (``:181-195``).

    Across ranks (``parallel/``: SyncBatchNorm, as JAX's ``groups=1``
    under ``DataParallel``) the statistics are the global batch's: K2's
    per-rank (s1, s2), or the plain sums of 'two' and 'one', all-reduced
    in the forward and their cotangents in the backward, n the global
    count; ``stats_sample`` takes the leading rows of the global batch,
    of which a rank may hold none; ``groups`` adds each rank's rows into
    the (g, C) sums of their groups, all-reduced, so a group may span
    ranks.  Every rank's running statistics stay equal.

    The defaults come from the environment: ``groups`` from
    ``CNSN_BN_GROUPS`` and ``stats_sample`` from ``CNSN_BN_SAMPLE`` when
    the layer is built (JAX reads them when ``norm.py`` is imported),
    ``var_impl`` from ``CNSN_BN_VAR`` at each training forward (JAX, at
    trace time).
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 groups: Optional[int] = None,
                 stats_sample: Optional[int] = None,
                 var_impl: Optional[str] = None):
        super().__init__(features, eps)
        self.groups = (int(os.environ.get("CNSN_BN_GROUPS", "1"))
                       if groups is None else groups)
        self.stats_sample = (int(os.environ.get("CNSN_BN_SAMPLE", "0"))
                             if stats_sample is None else stats_sample)
        self.var_impl = var_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # F.batch_norm with fp32 statistics and a bf16 input computes
            # in fp32 and writes bf16, in one pass, keeping the layout
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        g = self.groups
        n_global, start = global_rows(x.shape[0])
        if g > 1 and n_global % g == 0:
            return self._grouped(x, g, start, n_global // g)
        s = self.stats_sample
        if 0 < s < n_global:
            # the leading s rows of the (global) batch: this rank's share
            # of them, which may be none
            xs = x[:min(max(s - start, 0), x.shape[0])]
        else:
            xs, s = x, n_global
        n = s * x.shape[2] * x.shape[3]
        var_impl = self.var_impl or os.environ.get("CNSN_BN_VAR", "shifted")
        if var_impl == "shifted":
            # the shift: a copy, since the running mean is updated in place
            # below while the backward still needs the value used here; a
            # recomputation takes the first run's
            m0 = replayed(self.running_mean.clone)
            s1, s2 = all_reduce_sum(*BnSums.apply(xs.permute(0, 2, 3, 1),
                                                  m0), kind="bn_sums")
            mean_d = s1 / n
            var = torch.clamp(s2 / n - mean_d.square(), min=0.0)
            mean = m0 + mean_d
        elif var_impl == "two":
            xf = xs.to(_stat_dtype(x))
            (total,) = all_reduce_sum(xf.sum(dim=(0, 2, 3)), kind="bn_stats")
            mean = total / n
            (dev,) = all_reduce_sum((xf - mean.reshape(1, -1, 1, 1)).square()
                                    .sum(dim=(0, 2, 3)), kind="bn_stats")
            var = dev / n
        elif var_impl == "one":
            xf = xs.to(_stat_dtype(x))
            total, sq = all_reduce_sum(xf.sum(dim=(0, 2, 3)),
                                       xf.square().sum(dim=(0, 2, 3)),
                                       kind="bn_stats")
            mean = total / n
            var = sq / n - mean.square()
        else:
            raise ValueError(f"BatchNorm var_impl {var_impl!r}: one of "
                             "'shifted', 'two', 'one'")
        self._update_running(mean, var, n)
        shape = (1, self.features, 1, 1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = ((x.to(_stat_dtype(x)) - mean.reshape(shape))
               * inv.reshape(shape) + self.bias.reshape(shape))
        return out.to(x.dtype)

    def _grouped(self, x: torch.Tensor, g: int, start: int,
                 rows: int) -> torch.Tensor:
        """Per-group two-pass statistics (``cnsn_tpu/nn/norm.py:122-129,
        181-188``), plain torch; each row normalized by its group's.  x
        holds rows [start, start + N) of the (global) batch, each group
        ``rows`` rows of it: the rows are added into the (g, C) sums of
        their groups, all-reduced across ranks (a group a rank does not
        touch gets zeros from it), once for the mean and once for the
        centred squares; every rank holds group 0's statistics."""
        xf = x.to(_stat_dtype(x))
        gid = torch.div(torch.arange(start, start + x.shape[0],
                                     device=x.device), rows,
                        rounding_mode="floor")
        n = rows * x.shape[2] * x.shape[3]

        def group_sums(t):  # (N, C, H, W) → (g, C), each row to its group
            return torch.zeros((g, self.features), dtype=t.dtype,
                               device=t.device).index_add(
                0, gid, t.sum(dim=(2, 3)))

        (total,) = all_reduce_sum(group_sums(xf), kind="bn_stats")
        mean = total / n                                         # (g, C)
        d = xf - mean[gid][:, :, None, None]
        (dev,) = all_reduce_sum(group_sums(d.square()), kind="bn_stats")
        var = dev / n
        self._update_running(mean[0], var[0], n)
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = d * inv[gid][:, :, None, None] + self.bias.reshape(1, -1, 1, 1)
        return out.to(x.dtype)


class BatchNorm1dStats(_NormStats):
    """torch.nn.BatchNorm1d over (N, C) per-channel scalars: the BN inside
    SelfNorm (``cnsn_tpu/nn/norm.py:198-235``).  Train: two-pass batch
    statistics in plain torch (the input is only (N, C)), across ranks
    over the global batch: the ranks' (N, C) gathered
    (``parallel/distributed.py::all_gather_rows``)."""

    def folded_affine(self):
        """``(a, b)`` with  BN(y) = a·y + b:  a = scale/sqrt(rv+eps),
        b = bias − a·rm (``cnsn_tpu/nn/cnsn.py:95-103``)."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - a * self.running_mean

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        yf = y.to(_stat_dtype(y))
        if self.training:
            # across ranks the gathered global (N, C), normalized as one
            # process normalizes it (the same graph: at one rank the same
            # bits), of which the rank keeps its rows
            yf = all_gather_rows(yf)
            mean = yf.mean(dim=0)
            var = (yf - mean).square().mean(dim=0)
            self._update_running(mean, var, yf.shape[0])
        else:
            mean, var = self.running_mean, self.running_var
        out = (yf - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return local_rows(out, y.shape[0]).to(y.dtype)


class InstanceNorm(nn.Module):
    """torch.nn.InstanceNorm2d(affine=True) over an NCHW (channels_last)
    tensor (``cnsn_tpu/nn/norm.py:238-258``): per-(sample, channel)
    statistics over H·W with the biased variance, in at least fp32, no
    running statistics, the same in train and eval.  Plain torch, as in
    the JAX package, where it reaches no Pallas kernel."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def extra_repr(self) -> str:
        return f"{self.features}, eps={self.eps}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        shape = (1, self.features, 1, 1)
        out = out * self.weight.reshape(shape) + self.bias.reshape(shape)
        return out.to(x.dtype)


class IBN(nn.Module):
    """Instance-Batch Normalization (``cnsn_tpu/nn/norm.py:313-327``):
    ``InstanceNorm`` on the first ``int(features · ratio)`` channels,
    ``BatchNorm`` on the rest, concatenated.  The BatchNorm half is
    copied into a channels_last tensor of its own, so that K2 reads it
    NHWC-contiguous."""

    def __init__(self, features: int, ratio: float = 0.5):
        super().__init__()
        self.half = int(features * ratio)
        self.IN = InstanceNorm(self.half)
        self.BN = BatchNorm(features - self.half)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_bn = x[:, self.half:].contiguous(memory_format=torch.channels_last)
        return torch.cat([self.IN(x[:, :self.half]), self.BN(x_bn)], dim=1)
