"""Per-instance (per-sample, per-channel) spatial statistics.

Port of ``cnsn_tpu/ops/stats.py``.  Tensors are NHWC, as in the JAX
package.  Parity with it:
  * one-pass variance E[x²]−E[x]² in fp32 (the JAX default
    ``CNSN_STATS_VAR=one``);
  * unbiased (ddof=1), with ``eps`` added to the variance inside the sqrt;
  * statistics in fp32 even for bf16 input, then cast to ``out_dtype``
    (x's type by default), as JAX casts them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .kernels.ins_stats import InsStats

__all__ = ["instance_mean_std", "masked_instance_mean_std", "region_mask"]


def instance_mean_std(x: torch.Tensor, eps: float = 1e-5, ddof: int = 1,
                      out_dtype: torch.dtype | None = None):
    """Spatial mean/std per (sample, channel) of an NHWC tensor.

    Returns ``(mean, std)`` each shaped (N, 1, 1, C).  Every device goes
    through ``InsStats`` and its analytic backward: a CUDA tensor launches
    the K1 kernels (x NHWC-contiguous), a CPU tensor runs their plain
    versions.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    mean, std = InsStats.apply(x, eps, ddof)
    shape = (x.shape[0], 1, 1, x.shape[3])
    dt = out_dtype or x.dtype
    return mean.reshape(shape).to(dt), std.reshape(shape).to(dt)


def region_mask(h: int, w: int, h1: int, h2: int, w1: int, w2: int,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """(1, H, W, 1) mask that is 1 inside rows [h1, h2) and columns
    [w1, w2), 0 elsewhere (``cnsn_tpu/ops/stats.py:77-90``)."""
    rows = torch.arange(h, device=device).reshape(1, h, 1, 1)
    cols = torch.arange(w, device=device).reshape(1, 1, w, 1)
    inside = (rows >= h1) & (rows < h2) & (cols >= w1) & (cols < w2)
    return inside.to(dtype)


def masked_instance_mean_std(x: torch.Tensor, box: Sequence[int],
                             eps: float = 1e-5, ddof: int = 1,
                             out_dtype: torch.dtype | None = None):
    """Mean/std per (N, C) over the box (h1, h2, w1, w2) of an NHWC
    tensor: JAX's ``masked_instance_mean_std`` with the mask
    ``region_mask(H, W, *box)`` (``cnsn_tpu/ops/stats.py:93-124``).

    The box is known on the host, so the masked sums are the sums of the
    slice ``x[:, h1:h2, w1:w2]`` with n its area, in JAX's formula:
    mean = s1/n, var = s2/n − mean², times n/max(n − ddof, 1), and
    std = sqrt(var + eps).  The JAX package has no kernel for these
    statistics; they are plain torch on every device, and autograd
    differentiates them.  Returns ``(mean, std)`` each (N, 1, 1, C).
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    h1, h2, w1, w2 = box
    xf = x[:, h1:h2, w1:w2].to(torch.promote_types(x.dtype, torch.float32))
    n = (h2 - h1) * (w2 - w1)
    mean = xf.sum(dim=(1, 2), keepdim=True) / n
    var = xf.square().sum(dim=(1, 2), keepdim=True) / n - mean.square()
    if ddof:
        # JAX forms n / max(n − ddof, 1) from the mask's fp32 count, in fp32
        var = var * (torch.tensor(float(n)) / float(max(n - ddof, 1))).item()
    std = torch.sqrt(var + eps)
    dt = out_dtype or x.dtype
    return mean.to(dt), std.to(dt)
