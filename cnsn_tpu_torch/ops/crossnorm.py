"""Functional 2-instance CrossNorm (style-statistics transfer).

Port of ``cnsn_tpu/ops/crossnorm.py`` for the mode the flagship recipe
runs: image-space CrossNorm with ``crop='neither'`` (statistics taken and
transferred over the whole plane).  Each instance takes the per-channel
spatial statistics of a partner drawn by a random permutation.

Randomness comes from an explicit ``torch.Generator``; every sampling
function also takes its draw from the caller (``perm``), so a test can
feed it the permutation JAX drew.  The crop modes 'style', 'content' and
'both' (bounding boxes and masked statistics, ``ops/bbox.py``) are not
ported yet (ROADMAP queue 1) and raise; so is the channel shuffle
``chan``, which the port's signature leaves out.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stats import instance_mean_std

__all__ = ["CROP_MODES", "cross_norm_2ins", "grouped_permutation",
           "instance_norm_mix"]

CROP_MODES = ("neither", "style", "content", "both")


def instance_norm_mix(content: torch.Tensor, style: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Replace content's per-(N, C) statistics with style's (AdaIN).
    NHWC; spatial sizes may differ, (N, C) must match."""
    if (content.shape[0] != style.shape[0]
            or content.shape[3] != style.shape[3]):
        raise ValueError("content/style must match in (N, C)")
    s_mean, s_std = instance_mean_std(style, eps=eps)
    c_mean, c_std = instance_mean_std(content, eps=eps)
    return (content - c_mean) / c_std * s_std + s_mean


def grouped_permutation(n: int, num_groups: int = 1,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Random permutation of [0, n) that stays within ``num_groups``
    contiguous blocks (per-shard pairing under data parallelism), on the
    generator's device."""
    if n % num_groups != 0:
        raise ValueError(f"batch {n} not divisible by num_groups "
                         f"{num_groups}")
    g = n // num_groups
    device = generator.device if generator is not None else None
    return torch.cat([torch.randperm(g, generator=generator, device=device)
                      + i * g for i in range(num_groups)])


def cross_norm_2ins(x: torch.Tensor, *, perm: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    crop: str = "neither", lam: Optional[float] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """2-instance CrossNorm on an NHWC batch:
    x_aug = (x − μ)/σ · σ[perm] + μ[perm], optionally mixed with x by
    ``lam``.  ``perm`` is the partner of each instance; when None it is
    drawn over the whole batch from ``generator``.

    JAX takes the instance statistics of x twice (``ops/crossnorm.py:103``
    and ``:120``); the port takes them once, so a call launches K1 once on
    a CUDA tensor.
    """
    if crop not in CROP_MODES:
        raise ValueError(f"crop must be one of {CROP_MODES}, got {crop!r}")
    if crop != "neither":
        raise NotImplementedError(
            "CrossNorm crop modes 'style'/'content'/'both' are not ported "
            "yet (ROADMAP queue 1: ops/bbox.py and the masked statistics)")
    if perm is None:
        perm = grouped_permutation(x.shape[0], 1, generator)
    perm = perm.to(x.device)
    mean, std = instance_mean_std(x, eps=eps)
    x_aug = (x - mean) / std * std[perm] + mean[perm]
    if lam is not None:
        x_aug = x * lam + x_aug * (1.0 - lam)
    return x_aug.to(x.dtype)
