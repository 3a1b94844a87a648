"""K2: shifted BatchNorm sums over every axis but the channel, forward and
backward.

Port of ``cnsn_tpu/ops/pallas/bn_stats.py``.  The TPU kernel
``bn_sums_pallas`` and the backward of ``bn_sums`` become the
hand-written CUDA kernels in ``cnsn_tpu_torch/csrc/bn_stats.cu`` (its
header states the design and the bounds); ``bn_sums_reference`` and
``bn_sums_bwd_reference`` are their plain PyTorch versions.

``BnSums`` joins the two as a ``torch.autograd.Function``: on a CPU tensor
it runs the plain versions, on a CUDA tensor it launches the kernels (or
raises), on any other device it raises.  The shift m0 is BatchNorm's
running mean, which JAX stop-gradients (``nn/norm.py:144``): ``BnSums``
gives it no gradient, so the TPU backward's dm0 term is not ported.
"""
from __future__ import annotations

import functools

import torch

from ._build import LAUNCHES
from ._launch import (DTYPE_CODE, INT, PTR, bind, check_activation,
                      check_f32, check_launch, stream, vector_width)

__all__ = ["BnSums", "bn_sums_bwd_cuda", "bn_sums_bwd_reference",
           "bn_sums_cuda", "bn_sums_reference"]


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def bn_sums_reference(x: torch.Tensor, m0: torch.Tensor):
    """Plain version: x (..., C), m0 (C,) fp32 →
    s1 = Σ(x−m0), s2 = Σ(x−m0)² over every axis but the last, each (C,)
    in fp32."""
    d = _float(x) - m0
    axes = tuple(range(x.dim() - 1))
    return d.sum(dim=axes), d.square().sum(dim=axes)


def bn_sums_bwd_reference(x, m0, g1, g2):
    """Plain version of the backward (``bn_stats.py:146-155``, without
    dm0): dx = g1 + 2(x−m0)·g2, in x's type."""
    d = _float(x) - m0
    return (g1 + 2.0 * d * g2).to(x.dtype)


@functools.cache
def _kernels():
    return (bind("bn_stats", "cnsn_bn_sums_chunks", INT, INT, INT),
            bind("bn_stats", "cnsn_bn_sums", INT, INT, PTR, PTR, PTR, PTR,
                 PTR, INT, INT, INT, PTR),
            bind("bn_stats", "cnsn_bn_sums_bwd", INT, INT, PTR, PTR, PTR,
                 PTR, PTR, INT, INT, PTR))


def bn_sums_cuda(x: torch.Tensor, m0: torch.Tensor):
    """Launch the forward kernels on the current stream; raise on a
    refused launch.  x is contiguous with C last (an NHWC activation);
    arguments and results as for ``bn_sums_reference``."""
    check_activation(x)
    c = x.shape[-1]
    rows = x.numel() // c
    check_f32(x, "m0", m0, (c,))
    vec = vector_width(x)
    chunks_of, fwd, _ = _kernels()
    s1 = torch.empty(c, dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(x.device):
        chunks = chunks_of(rows, c, vec)
        if chunks < 1:
            raise RuntimeError("bn_sums: cannot query the device")
        part = torch.empty((2, chunks, c), dtype=torch.float32,
                           device=x.device)
        err = fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(), m0.data_ptr(),
                  part.data_ptr(), s1.data_ptr(), s2.data_ptr(), rows, c,
                  chunks, stream(x))
    check_launch(err, "bn_sums")
    LAUNCHES["bn_sums"] += 1
    return s1, s2


def bn_sums_bwd_cuda(x, m0, g1, g2):
    """Launch the backward kernel on the current stream; raise on a
    refused launch.  Arguments and result as for
    ``bn_sums_bwd_reference``; m0, g1 and g2 are contiguous (C,) fp32."""
    check_activation(x)
    c = x.shape[-1]
    for name, t in (("m0", m0), ("g1", g1), ("g2", g2)):
        check_f32(x, name, t, (c,))
    vec = vector_width(x)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernels()[2](DTYPE_CODE[x.dtype], vec, x.data_ptr(),
                            m0.data_ptr(), g1.data_ptr(), g2.data_ptr(),
                            dx.data_ptr(), x.numel() // c, c, stream(x))
    check_launch(err, "bn_sums_bwd")
    LAUNCHES["bn_sums_bwd"] += 1
    return dx


class BnSums(torch.autograd.Function):
    """(s1, s2) = BnSums.apply(x, m0), each (C,) fp32, with the
    elementwise backward into x; m0 gets no gradient."""

    @staticmethod
    def forward(ctx, x, m0):
        on_cpu = x.device.type == "cpu"
        s1, s2 = (bn_sums_reference if on_cpu else bn_sums_cuda)(x, m0)
        ctx.save_for_backward(x, m0)
        return s1, s2

    @staticmethod
    def backward(ctx, g1, g2):
        x, m0 = ctx.saved_tensors
        bwd = (bn_sums_bwd_reference if x.device.type == "cpu"
               else bn_sums_bwd_cuda)
        return bwd(x, m0, g1.contiguous(), g2.contiguous()), None
