"""K1: per-(sample, channel) spatial mean and std, forward and backward.

Port of ``cnsn_tpu/ops/pallas/ins_stats.py``.  The TPU kernels
``ins_stats_pallas`` / ``ins_stats_v2`` and the backward of
``ins_stats_diff`` become the hand-written CUDA kernels in
``cnsn_tpu_torch/csrc/ins_stats.cu`` (its header states the design and
the bounds); ``ins_stats_reference`` and ``ins_stats_bwd_reference`` are
their plain PyTorch versions.

``InsStats`` joins the two as a ``torch.autograd.Function``: on a CPU
tensor it runs the plain versions, on a CUDA tensor it launches the
kernels (or raises), on any other device it raises.  x is NHWC; a model
activation passes its NHWC-contiguous ``permute(0, 2, 3, 1)`` view.
"""
from __future__ import annotations

import functools

import torch

from ._build import LAUNCHES
from ._launch import (DTYPE_CODE, FLOAT, INT, PTR, bind, check_activation,
                      check_f32, check_launch, stream, vector_width)

__all__ = ["InsStats", "ins_stats_bwd_cuda", "ins_stats_bwd_reference",
           "ins_stats_cuda", "ins_stats_reference"]


def ins_stats_reference(x: torch.Tensor, eps: float = 1e-5, ddof: int = 1):
    """Plain version: x NHWC → (mean, std), each (N, C), in fp32 (float64
    input stays float64).  One-pass variance E[x²]−E[x]², unbiased by
    HW/max(HW−ddof, 1), eps added inside the sqrt, no clamp: the JAX
    default (``cnsn_tpu/ops/stats.py``, ``CNSN_STATS_VAR=one``)."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.shape[1] * x.shape[2]
    mean = xf.mean(dim=(1, 2))
    var = xf.square().mean(dim=(1, 2)) - mean.square()
    if ddof:
        var = var * (n / max(n - ddof, 1))
    return mean, torch.sqrt(var + eps)


def ins_stats_bwd_reference(x, mean, std, gm, gs, ddof: int = 1):
    """Plain version of the backward (``ins_stats.py:179-190``):
    dx = gm/HW + gs·(x−mean)/(max(HW−ddof, 1)·std), in x's type, from
    (N, C) statistics and cotangents."""
    n, h, w, c = x.shape
    hw = h * w
    shape = (n, 1, 1, c)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dx = (gm.reshape(shape) / hw + gs.reshape(shape)
          * (xf - mean.reshape(shape))
          / (max(hw - ddof, 1) * std.reshape(shape)))
    return dx.to(x.dtype)


@functools.cache
def _kernels():
    return (bind("ins_stats", "cnsn_ins_stats_chunks", INT, INT, INT, INT),
            bind("ins_stats", "cnsn_ins_stats", INT, INT, PTR, PTR, PTR, PTR,
                 INT, INT, INT, INT, FLOAT, INT, PTR),
            bind("ins_stats", "cnsn_ins_stats_bwd", INT, INT, PTR, PTR, PTR,
                 PTR, PTR, PTR, INT, INT, INT, INT, PTR))


def _check_x(x):
    check_activation(x, ndim=4)
    if x.shape[0] > 65535 or x.shape[0] * x.shape[3] >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")


def ins_stats_cuda(x: torch.Tensor, eps: float = 1e-5, ddof: int = 1):
    """Launch the forward kernel on the current stream; raise on a refused
    launch.  Arguments and results as for ``ins_stats_reference``."""
    _check_x(x)
    if ddof < 0:
        raise ValueError(f"ddof must be >= 0, got {ddof}")
    n, h, w, c = x.shape
    vec = vector_width(x)
    chunks_of, fwd, _ = _kernels()
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    std = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        chunks = chunks_of(n, h * w, c, vec)
        if chunks < 1:
            raise RuntimeError("ins_stats: cannot query the device")
        part = torch.empty((2, n, chunks, c), dtype=torch.float32,
                           device=x.device)
        err = fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(), part.data_ptr(),
                  mean.data_ptr(), std.data_ptr(), n, h * w, c, chunks, eps,
                  ddof, stream(x))
    check_launch(err, "ins_stats")
    LAUNCHES["ins_stats"] += 1
    return mean, std


def ins_stats_bwd_cuda(x, mean, std, gm, gs, ddof: int = 1):
    """Launch the backward kernel on the current stream; raise on a refused
    launch.  Arguments and result as for ``ins_stats_bwd_reference``;
    mean, std, gm and gs are contiguous (N, C) fp32."""
    _check_x(x)
    if ddof < 0:
        raise ValueError(f"ddof must be >= 0, got {ddof}")
    n, h, w, c = x.shape
    for name, t in (("mean", mean), ("std", std), ("gm", gm), ("gs", gs)):
        check_f32(x, name, t, (n, c))
    vec = vector_width(x)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernels()[2](DTYPE_CODE[x.dtype], vec, x.data_ptr(),
                            mean.data_ptr(), std.data_ptr(), gm.data_ptr(),
                            gs.data_ptr(), dx.data_ptr(), n, h * w, c, ddof,
                            stream(x))
    check_launch(err, "ins_stats_bwd")
    LAUNCHES["ins_stats_bwd"] += 1
    return dx


class InsStats(torch.autograd.Function):
    """(mean, std) = InsStats.apply(x, eps, ddof), each (N, C) fp32, with
    the analytic backward; no gradient for eps and ddof."""

    @staticmethod
    def forward(ctx, x, eps, ddof):
        on_cpu = x.device.type == "cpu"
        mean, std = (ins_stats_reference if on_cpu else ins_stats_cuda)(
            x, eps, ddof)
        ctx.save_for_backward(x, mean, std)
        ctx.ddof = ddof
        return mean, std

    @staticmethod
    def backward(ctx, gm, gs):
        x, mean, std = ctx.saved_tensors
        bwd = (ins_stats_bwd_reference if x.device.type == "cpu"
               else ins_stats_bwd_cuda)
        return (bwd(x, mean, std, gm.contiguous(), gs.contiguous(),
                    ctx.ddof), None, None)
