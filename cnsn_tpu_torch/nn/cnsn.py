"""CrossNorm / SelfNorm / CNSN: port of ``cnsn_tpu/nn/cnsn.py``.

Activations are NCHW tensors in ``torch.channels_last`` memory; the ops
see their NHWC-contiguous ``permute(0, 2, 3, 1)`` view.  Eval SelfNorm
folds its BatchNorm1d running statistics into an affine and runs the
fused K3 op (``ops/kernels/selfnorm.py``); train SelfNorm takes its
instance statistics through K1 (``ops/stats.py``).  Parameter names
follow the reference torch modules (``selfnorm.g_fc.weight`` of shape
(C, 1, 2), ``selfnorm.g_bn.*``).

A CrossNorm site's gate is a host bool (the train step samples the site
mask on the host), and its random draws come from the caller or from a
generator (``ops/crossnorm.py``), where JAX derives a key per site from
its module path.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ..ops.crossnorm import (cross_norm_2ins, cross_norm_fma, draw,
                             pair_stats)
from ..ops.kernels.selfnorm import selfnorm_infer
from ..ops.stats import instance_mean_std
from .norm import BatchNorm1dStats

__all__ = ["CrossNorm", "SelfNorm", "CNSN", "set_num_groups"]

# CrossNorm's statistics eps (``ops/crossnorm.py``), which the fused CNSN
# path's algebra removes again (``nn/cnsn.py:187``)
EPS_CN = 1e-5


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class CrossNorm(nn.Module):
    """One CrossNorm site (``nn/cnsn.py:38-71``) with the knobs the models
    set, ``crop`` and ``beta``, and ``num_groups``, which
    ``set_num_groups`` sets (the pairing stays within each of
    ``num_groups`` contiguous blocks of the global batch, one a rank under
    data parallelism; lam, chan and bbx_thres keep the defaults the JAX
    models leave them at).  The
    implementation is read from ``CNSN_CN_IMPL`` when the site is built,
    as JAX reads it: 'fma' (the default) is ``cross_norm_fma``, 'cond' is
    ``cross_norm_2ins``.

    ``active`` None (eval, plain forward) or False is the identity: JAX's
    'fma' gives x·1 + 0 in fp32, cast back, which is x, and 'cond' takes
    the identity branch; neither draws nor launches anything here."""

    def __init__(self, crop: str = "neither", beta: float = 1.0):
        super().__init__()
        impl = os.environ.get("CNSN_CN_IMPL", "fma")
        if impl not in ("fma", "cond"):
            raise ValueError(f"CrossNorm impl must be 'fma' or 'cond', got "
                             f"{impl!r}")
        self.impl = impl
        self.kw = dict(crop=crop, beta=beta, num_groups=1)

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``draws``: this site's perm, style_box and content_box, any of
        them; the rest from ``generator``."""
        if not active:
            return x
        kw = dict(self.kw, generator=generator, **(draws or {}))
        out = (cross_norm_fma(_nhwc(x), True, **kw) if self.impl == "fma"
               else cross_norm_2ins(_nhwc(x), **kw))
        return _nchw(out)


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

    ``is_two`` adds the mean-recalibration branch (``:143-148``; no model
    of the reference turns it on): a second pair-FC ``f_fc`` and BN1d
    ``f_bn`` give f as the first give g, and out = x·g + mean·(f − g), in
    x's type.  Its statistics come from K1 in train and eval alike, and
    eval runs the train formula on the running statistics: K3 computes no
    f, and JAX keeps ``is_two`` off its fused path (``:117``).
    """

    def __init__(self, features: int, is_two: bool = False,
                 eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator or torch.Generator()
        self.features = features
        self.is_two = is_two
        self.eps = eps
        self.g_fc = _PairFC(features, generator)
        self.g_bn = BatchNorm1dStats(features)
        if is_two:
            self.f_fc = _PairFC(features, generator)
            self.f_bn = BatchNorm1dStats(features)

    def forward(self, x: torch.Tensor, stats=None,
                gate_only: bool = False) -> torch.Tensor:
        """``stats``: precomputed (mean, std), each (N, C), which the fused
        CNSN path knows analytically; ``gate_only`` returns the gate g,
        (N, C, 1, 1) in x's type, instead of x·g."""
        if gate_only and self.is_two:
            raise ValueError("SelfNorm gate_only has no is_two branch "
                             "(cnsn_tpu/nn/cnsn.py:140)")
        w = self.g_fc.weight.reshape(self.features, 2)
        if (not self.training and stats is None and not gate_only
                and not self.is_two):
            a, b = self.g_bn.folded_affine()
            return _nchw(selfnorm_infer(_nhwc(x), w, a, b, self.eps))
        n, c = x.shape[0], self.features
        if stats is None:
            mean, std = instance_mean_std(_nhwc(x), eps=self.eps)
            stats = (mean.reshape(n, c), std.reshape(n, c))
        sdt = torch.promote_types(x.dtype, torch.float32)
        m, s = stats[0].to(sdt), stats[1].to(sdt)

        def gate(fc, bn):
            w = fc.weight.reshape(c, 2)
            y = m * w[:, 0] + s * w[:, 1]
            return torch.sigmoid(bn(y)).to(x.dtype).reshape(n, c, 1, 1)

        g = gate(self.g_fc, self.g_bn)
        if gate_only:
            return g
        if not self.is_two:
            return x * g
        f = gate(self.f_fc, self.f_bn)
        return x * g + stats[0].to(x.dtype).reshape(n, c, 1, 1) * (f - g)


class CNSN(nn.Module):
    """CrossNorm-then-SelfNorm composition for ``cnsn_type`` in
    {'cn', 'sn', 'cnsn'} (``nn/cnsn.py:152-218``).

    Fused path (unless ``CNSN_FUSE=0`` when the site is built, as JAX
    reads it): on a
    CrossNorm forward (``active`` not None, whether or not this site is
    on) of a 'cnsn' site with crop 'neither' or 'style', CrossNorm's
    output is x·scale + shift per (N, C), so SelfNorm's statistics follow
    from CrossNorm's one pass (fp32, eps 1e-5, K1 on the card):
    μ_out = μ_c·scale + shift, σ_out = sqrt(max(σ_c² − 1e-5, 0)·scale²
    + 1e-12), and out = x·(scale·g) + shift·g in fp32.  An idle site has
    scale 1 and shift 0, and still takes its SelfNorm statistics from
    that pass, as JAX does."""

    def __init__(self, features: int, cnsn_type: str, crop: str = "neither",
                 beta: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cnsn_type not in ("cn", "sn", "cnsn"):
            raise ValueError(f"bad cnsn_type {cnsn_type!r}")
        self.fused = (os.environ.get("CNSN_FUSE", "1") == "1"
                      and cnsn_type == "cnsn"
                      and crop in ("neither", "style"))
        self.crossnorm = CrossNorm(crop, beta) if "cn" in cnsn_type else None
        self.selfnorm = (SelfNorm(features, generator=generator)
                         if "sn" in cnsn_type else None)

    def forward(self, x: torch.Tensor, active: Optional[bool] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.fused and active is not None:
            return self._fused(x, active, draws or {}, generator)
        if self.crossnorm is not None:
            x = self.crossnorm(x, active, draws, generator)
        if self.selfnorm is not None:
            x = self.selfnorm(x)
        return x

    def _fused(self, x, active, draws, generator):
        xh = _nhwc(x)
        n, c = x.shape[0], x.shape[1]
        ct = torch.promote_types(x.dtype, torch.float32)
        if active:
            kw = self.crossnorm.kw
            d = draw(xh, kw["crop"], beta=kw["beta"],
                     num_groups=kw["num_groups"], generator=generator,
                     **draws)
            (s_mean, s_std), (cm, cs) = pair_stats(xh, kw["crop"], d,
                                                   EPS_CN, out_dtype=ct)
            scale = s_std / cs
            shift = s_mean - cm * scale
            sn_mean = cm * scale + shift
            var = torch.clamp(cs * cs - EPS_CN, min=0.0) * (scale * scale)
        else:  # scale 1, shift 0: each expression, exactly
            cm, cs = instance_mean_std(xh, eps=EPS_CN, out_dtype=ct)
            sn_mean = cm
            var = torch.clamp(cs * cs - EPS_CN, min=0.0)
        sn_std = torch.sqrt(var + self.selfnorm.eps)
        g = self.selfnorm(x, stats=(sn_mean.reshape(n, c),
                                    sn_std.reshape(n, c)),
                          gate_only=True).to(ct)
        g = _nhwc(g)  # (N, 1, 1, C)
        xf = xh.to(ct)
        out = xf * (scale * g) + shift * g if active else xf * g
        return _nchw(out.to(x.dtype))


def set_num_groups(model: nn.Module, num_groups: int) -> nn.Module:
    """Every CrossNorm site of ``model`` pairs within ``num_groups``
    contiguous blocks of the global batch (the JAX models' ``num_groups``
    knob, which their constructors pass to each site; the builders,
    ``build_model`` and ``build_seg_model``, take it); returns
    ``model``."""
    for m in model.modules():
        if isinstance(m, CrossNorm):
            m.kw["num_groups"] = num_groups
    return model
