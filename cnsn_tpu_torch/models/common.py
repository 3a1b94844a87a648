"""Shared model-building helpers: port of ``cnsn_tpu/models/common.py``.

Torch-parity initializers drawn from an explicit ``torch.Generator`` and
bias-free conv / torch-default linear layers.  Conv weights are OIHW in
``torch.channels_last`` memory, so cuDNN runs NHWC.  ``dtype`` is the
compute type (bf16 for fast serving): parameters stay fp32 and are cast
at use, as the JAX package does.

``conv_he_fanout`` reads ``CNSN_CONV3X3`` when a model is built, as the
JAX factory does, and makes every 3×3 conv a ``ConvCustomBwd`` (the same
``weight``, the stock forward, gradients chosen in ``ops/convdot.py``)
unless it is ``conv``, the default.

Not ported, on purpose: ``S2DStem`` (a TPU matrix-unit trick, algebraically
identical to the plain 7×7/s2 stem on the same parameter) and
``Conv1x1Dot`` (the same math as a 1×1 conv).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convdot import Conv2dCustomBwd

__all__ = ["he_fanout_normal", "torch_linear_uniform", "Conv2d",
           "ConvCustomBwd", "Linear", "conv_he_fanout"]

# CNSN_CONV3X3 → (wgrad, dgrad) of a 3×3 conv's backward
# (``cnsn_tpu/models/common.py:107-112``); 'conv' keeps the stock conv
CONV3X3_MODES = {"dot": ("dot", "dot"), "wgrad": ("dot", "auto"),
                 "dgrad": ("auto", "dot"), "pallas": ("pallas", "auto"),
                 "pallas_tiled": ("pallas_tiled", "auto")}


def he_fanout_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """He-normal with fan_out = out_channels·kH·kW for an OIHW shape (the
    explicit init of every reference model)."""
    fan_out = shape[0] * shape[2] * shape[3]
    return torch.randn(shape, generator=generator) * (2.0 / fan_out) ** 0.5


def torch_linear_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """torch.nn.Linear default weight init for an (out, in) shape:
    U(±1/sqrt(in))."""
    bound = 1.0 / shape[1] ** 0.5
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def _compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]):
    # dtype=None matches flax's promotion: bf16 x with fp32 params runs fp32
    return dtype or torch.promote_types(x.dtype, torch.float32)


class Conv2d(nn.Module):
    """Bias-free 2-D convolution with He(fan_out) init, ``weight`` OIHW in
    channels_last memory.  Padding k//2: the reference's 0 for 1×1, 1 for
    3×3 and 3 for 7×7."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2
        self.dtype = dtype
        w = he_fanout_normal((out_ch, in_ch, kernel, kernel),
                             generator or torch.Generator())
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.dtype)
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)

    def extra_repr(self) -> str:
        o, i, k, _ = self.weight.shape
        return (f"{i}, {o}, kernel={k}, stride={self.stride}, "
                f"padding={self.padding}, dtype={self.dtype}")


class Linear(nn.Module):
    """Linear layer with torch-default weight init and zero bias (the
    reference zeroes classifier biases)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch_linear_uniform(
            (out_features, in_features), generator or torch.Generator()))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvCustomBwd(Conv2d):
    """A ``Conv2d`` (the same ``weight``, init and forward) whose
    gradients in training are chosen per side by ``wgrad`` and ``dgrad``
    (``ops/convdot.py``).  In eval or without grad it runs the stock
    ``F.conv2d``, so serving and ``torch.export`` see a plain conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 wgrad: str = "dot", dgrad: str = "dot",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel, stride, dtype, generator)
        self.wgrad, self.dgrad = wgrad, dgrad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and torch.is_grad_enabled()):
            return super().forward(x)
        dt = _compute_dtype(x, self.dtype)
        return Conv2dCustomBwd.apply(x.to(dt), self.weight.to(dt),
                                     self.stride, self.padding, self.wgrad,
                                     self.dgrad)

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, wgrad={self.wgrad}, dgrad={self.dgrad}"


def conv_he_fanout(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                   dtype: Optional[torch.dtype] = None,
                   generator: Optional[torch.Generator] = None) -> Conv2d:
    """The models' conv factory (``cnsn_tpu/models/common.py:86-120``):
    a ``ConvCustomBwd`` for a 3×3 conv when ``CNSN_CONV3X3`` is one of
    dot, wgrad, dgrad, pallas, pallas_tiled; a ``Conv2d`` otherwise and
    for ``conv`` (unset).  Other values raise."""
    mode = os.environ.get("CNSN_CONV3X3", "conv")
    if mode != "conv" and mode not in CONV3X3_MODES:
        raise ValueError(f"CNSN_CONV3X3={mode!r}: one of conv, "
                         f"{', '.join(CONV3X3_MODES)}")
    if kernel == 3 and mode != "conv":
        wgrad, dgrad = CONV3X3_MODES[mode]
        return ConvCustomBwd(in_ch, out_ch, kernel, stride, wgrad, dgrad,
                             dtype, generator)
    return Conv2d(in_ch, out_ch, kernel, stride, dtype, generator)
