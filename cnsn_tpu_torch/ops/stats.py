"""Per-instance (per-sample, per-channel) spatial statistics.

Port of ``cnsn_tpu/ops/stats.py::instance_mean_std``.  Tensors are NHWC,
as in the JAX package.  Parity with it:
  * one-pass variance E[x²]−E[x]² in fp32 (the JAX default
    ``CNSN_STATS_VAR=one``);
  * unbiased (ddof=1), with ``eps`` added to the variance inside the sqrt;
  * statistics in fp32 even for bf16 input, then cast to ``out_dtype``
    (x's type by default), as JAX casts them.
"""
from __future__ import annotations

import torch

from .kernels.ins_stats import InsStats

__all__ = ["instance_mean_std"]


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
