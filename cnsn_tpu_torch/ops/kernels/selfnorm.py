"""K3: fused eval-mode SelfNorm, one read and one write of x.

Port of ``cnsn_tpu/ops/pallas/selfnorm.py``.  The TPU kernel
``selfnorm_infer_pallas`` becomes the hand-written CUDA kernel in
``cnsn_tpu_torch/csrc/selfnorm.cu`` (its header states the design and the
bound); ``selfnorm_infer_reference`` is its plain PyTorch version.

``selfnorm_infer`` is the op the model calls.  It is registered as
``torch.ops.cnsn_tpu_torch.selfnorm_infer`` so that ``torch.export`` keeps
it as one node: on a CPU tensor it runs the plain version, on a CUDA
tensor it launches the kernel (or raises), and on any other device it
raises.

Layout: x is NHWC, as in the JAX package.  The model's activations are
NCHW tensors in ``torch.channels_last`` memory; their ``permute(0, 2, 3,
1)`` view is NHWC-contiguous and is what the model passes, at no copy.
"""
import functools

import torch

from ._build import LAUNCHES
from ._launch import (DTYPE_CODE, FLOAT, INT, PTR, bind, check_activation,
                      check_f32, check_launch, stream)
from .ins_stats import ins_stats_reference

__all__ = ["selfnorm_infer", "selfnorm_infer_cuda",
           "selfnorm_infer_reference"]


def selfnorm_infer_reference(x, w, a, b, eps: float = 1e-12, ddof: int = 1):
    """Plain version.  x: NHWC f32/bf16; w: (C, 2) g_fc weight; a, b: (C,)
    the folded BN-eval affine  a = scale/sqrt(rv+eps_bn),  b = bias − a·rm.

    Rounds as the Pallas kernel does: x·g is taken in fp32 and then cast
    to x's type.  (The JAX jnp eval path casts g to bf16 before the
    product, so in bf16 the two JAX paths differ by up to 1 ulp; the port
    follows the kernel.)
    """
    n, _, _, c = x.shape
    xf = x.float()
    mean, std = ins_stats_reference(xf, eps=eps, ddof=ddof)
    y = w[:, 0] * mean + w[:, 1] * std
    g = torch.sigmoid(a * y + b).reshape(n, 1, 1, c)
    return (xf * g).to(x.dtype)


@functools.cache
def _kernel():
    return bind("selfnorm", "cnsn_selfnorm_infer", INT, PTR, PTR, PTR, PTR,
                PTR, INT, INT, INT, FLOAT, PTR)


def selfnorm_infer_cuda(x, w, a, b, eps: float = 1e-12):
    """Launch the CUDA kernel on the current stream; raise on a refused
    launch.  Arguments as for ``selfnorm_infer_reference`` (ddof is 1)."""
    check_activation(x, ndim=4)
    n, h, wd, c = x.shape
    if n > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    for name, t, shape in (("w", w, (c, 2)), ("a", a, (c,)), ("b", b, (c,))):
        check_f32(x, name, t, shape)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernel()(DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                        a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                        h * wd, c, eps, stream(x))
    check_launch(err, "selfnorm_infer")
    LAUNCHES["selfnorm_infer"] += 1
    return out


@torch.library.custom_op("cnsn_tpu_torch::selfnorm_infer", mutates_args=(),
                         device_types="cpu")
def selfnorm_infer(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Fused eval SelfNorm: the plain version on CPU tensors, the CUDA
    kernel on CUDA tensors.  Arguments as for
    ``selfnorm_infer_reference`` (ddof is 1)."""
    return selfnorm_infer_reference(x, w, a, b, eps)


selfnorm_infer.register_kernel("cuda")(selfnorm_infer_cuda)


@selfnorm_infer.register_fake
def _(x, w, a, b, eps=1e-12):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
