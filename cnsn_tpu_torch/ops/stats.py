"""Per-instance (per-sample, per-channel) spatial statistics.

Port of ``cnsn_tpu/ops/stats.py::instance_mean_std``.  Tensors are NHWC,
as in the JAX package.  Parity with it:
  * one-pass variance E[x²]−E[x]² in fp32 (the JAX default
    ``CNSN_STATS_VAR=one``);
  * unbiased (ddof=1), with ``eps`` added to the variance inside the sqrt;
  * statistics in fp32 even for bf16 input.
"""
from __future__ import annotations

import torch

__all__ = ["instance_mean_std"]


def instance_mean_std(x: torch.Tensor, eps: float = 1e-5, ddof: int = 1,
                      out_dtype: torch.dtype | None = None):
    """Spatial mean/std per (sample, channel) of an NHWC tensor.

    Returns ``(mean, std)`` each shaped (N, 1, 1, C).
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.shape[1] * x.shape[2]
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.square().mean(dim=(1, 2), keepdim=True) - mean.square()
    if ddof:
        var = var * (n / max(n - ddof, 1))
    std = torch.sqrt(var + eps)
    dt = out_dtype or x.dtype
    return mean.to(dt), std.to(dt)
