"""Convolution with chosen gradients: port of ``cnsn_tpu/ops/convdot.py``.

``Conv2dCustomBwd`` is a ``torch.autograd.Function`` whose forward is the
stock ``F.conv2d`` and whose backward computes each gradient the way
JAX's ``_vjp_bwd`` (``convdot.py:93-139``) chooses, per side:

  wgrad  'dot'           nine tap-wise products (``_wgrad_taps``), any stride
         'auto'          the library's gradient (aten ``convolution_backward``)
         'pallas'        K4 (``ops/kernels/conv_wgrad.py``) for a 3×3
                         stride-1 conv, else 'auto'
         'pallas_tiled'  K4 where JAX's measured shape gate
                         (``wgrad3x3_tiled_wins``) holds, else 'auto'
  dgrad  'dot'           stride 1: a forward conv with the flipped,
                         transposed kernel (``_dgrad_flip_conv``), else 'auto'
         'auto'          the library's gradient

JAX also runs its Pallas kernel only where ``wgrad3x3_fits`` (a v5e VMEM
budget) holds; that holds at every ResNet-50 and WRN-40-2 shape and has
no Hopper meaning, so every 3×3 stride-1 conv under 'pallas' goes to K4.
dW is returned in the weight's type, as ``.astype(k.dtype)`` does
(``:124-129``): a bf16 conv rounds its K4 gradient to bf16.

``conv2d_custom_bwd`` takes the JAX layouts (x NHWC, k HWIO); the
modules call the Function on NCHW (channels_last) views and OIHW weights.
"""
from __future__ import annotations

import collections
import os

import torch
import torch.nn.functional as F

from .kernels.conv_wgrad import wgrad3x3_cuda, wgrad3x3_reference

__all__ = ["Conv2dCustomBwd", "LAYOUT_COPIES", "conv2d_custom_bwd",
           "routes_to_k4", "tiled_wins"]

WGRAD_MODES = ("dot", "auto", "pallas", "pallas_tiled")
DGRAD_MODES = ("dot", "auto")

# Copies the backward makes so that K4 reads NHWC-contiguous operands
# (an x or dy whose NHWC view is strided), by operand.
LAYOUT_COPIES: collections.Counter = collections.Counter()


def tiled_wins(h: int, w: int, cin: int, cout: int) -> bool:
    """JAX's ``wgrad3x3_tiled_wins`` (``conv_wgrad.py:42-57``) without its
    VMEM plan: the shape class where the batch-tiled kernel beat XLA's
    gradient on the TPU (ResNet-50 layer4, 7×7 512→512);
    ``CNSN_WGRAD_TILED_FORCE=1`` drops the shape test."""
    if os.environ.get("CNSN_WGRAD_TILED_FORCE") == "1":
        return True
    return h * w <= 64 and min(cin, cout) >= 512


def routes_to_k4(wgrad: str, stride: int, kernel_hw, h: int, w: int,
                 cin: int, cout: int) -> bool:
    """Whether the weight gradient of a conv over an (h, w) input goes to
    K4 (``_vjp_bwd``'s ``use_pallas``, ``convdot.py:96-113``)."""
    if wgrad not in ("pallas", "pallas_tiled") or stride != 1 \
            or tuple(kernel_hw) != (3, 3):
        return False
    return wgrad == "pallas" or tiled_wins(h, w, cin, cout)


def _nhwc(t: torch.Tensor, name: str) -> torch.Tensor:
    """t's NHWC view, copied where it is not contiguous (counted)."""
    v = t.permute(0, 2, 3, 1)
    if v.is_contiguous():
        return v
    LAYOUT_COPIES[name] += 1
    return v.contiguous()


def _wgrad_taps(x, dy, kshape, stride, padding):
    """dW[co, ci, kh, kw] = Σ_{b,h,w} x_pad[b, ci, s·h+kh, s·w+kw]·dy[b, co,
    h, w]: one product per tap contracting (B, Ho, Wo), in at least fp32
    (``convdot.py:61-80``)."""
    cout, cin, kh_n, kw_n = kshape
    ho, wo = dy.shape[2], dy.shape[3]
    dt = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(dt), (padding,) * 4)
    d = dy.to(dt).permute(0, 2, 3, 1).reshape(-1, cout)
    taps = [xp[:, :, kh:kh + stride * (ho - 1) + 1:stride,
               kw:kw + stride * (wo - 1) + 1:stride]
            .permute(0, 2, 3, 1).reshape(-1, cin).T @ d
            for kh in range(kh_n) for kw in range(kw_n)]
    return torch.stack(taps).reshape(kh_n, kw_n, cin, cout).permute(3, 2, 0, 1)


def _dgrad_flip_conv(dy, k, padding):
    """Stride-1 dgrad as a forward conv of dy with the spatially flipped
    kernel, in and out channels swapped, padding K−1−p
    (``convdot.py:83-90``)."""
    kt = k.flip(2, 3).transpose(0, 1)
    return F.conv2d(dy, kt, None, 1, k.shape[2] - 1 - padding)


class Conv2dCustomBwd(torch.autograd.Function):
    """y = Conv2dCustomBwd.apply(x, k, stride, padding, wgrad, dgrad): x
    NCHW, k OIHW, bias-free, one group; the forward is ``F.conv2d``."""

    @staticmethod
    def forward(ctx, x, k, stride: int, padding: int, wgrad: str,
                dgrad: str):
        if wgrad not in WGRAD_MODES or dgrad not in DGRAD_MODES:
            raise ValueError(f"wgrad one of {WGRAD_MODES}, dgrad one of "
                             f"{DGRAD_MODES}; got {wgrad!r}, {dgrad!r}")
        ctx.save_for_backward(x, k)
        ctx.conf = (stride, padding, wgrad, dgrad)
        return F.conv2d(x, k, None, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        x, k = ctx.saved_tensors
        stride, padding, wgrad, dgrad = ctx.conf
        need_dx, need_dk = ctx.needs_input_grad[:2]
        cout, cin = k.shape[:2]
        k4 = need_dk and routes_to_k4(wgrad, stride, k.shape[2:], x.shape[2],
                                      x.shape[3], cin, cout)
        flip = need_dx and dgrad == "dot" and stride == 1
        auto_dx = need_dx and not flip
        auto_dk = need_dk and not k4 and wgrad != "dot"
        dx = dk = None
        if auto_dx or auto_dk:
            dx, dk, _ = torch.ops.aten.convolution_backward(
                dy, x, k, None, [stride] * 2, [padding] * 2, [1, 1], False,
                [0, 0], 1, [auto_dx, auto_dk, False])
        if k4:
            # the plain version on a CPU tensor; the kernel, or a raise
            wgrad3x3 = (wgrad3x3_reference if x.device.type == "cpu"
                        else wgrad3x3_cuda)
            dk = wgrad3x3(_nhwc(x, "x"), _nhwc(dy, "dy")).permute(3, 2, 0, 1)
        elif need_dk and wgrad == "dot":
            dk = _wgrad_taps(x, dy, k.shape, stride, padding)
        if dk is not None:
            dk = dk.to(k.dtype, memory_format=torch.channels_last)
        if flip:
            dx = _dgrad_flip_conv(dy, k, padding).to(x.dtype)
        return dx, dk, None, None, None, None


def conv2d_custom_bwd(x: torch.Tensor, k: torch.Tensor, stride: int,
                      padding: int, wgrad: str = "dot",
                      dgrad: str = "dot") -> torch.Tensor:
    """JAX's signature and layouts: x NHWC, k HWIO → y NHWC."""
    y = Conv2dCustomBwd.apply(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                              stride, padding, wgrad, dgrad)
    return y.permute(0, 2, 3, 1)
