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
import ctypes
import functools

import torch

from ..stats import instance_mean_std
from ._build import LAUNCHES, load

__all__ = ["selfnorm_infer", "selfnorm_infer_cuda",
           "selfnorm_infer_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    mean, std = instance_mean_std(xf, eps=eps, ddof=ddof)
    y = w[:, 0] * mean.reshape(n, c) + w[:, 1] * std.reshape(n, c)
    g = torch.sigmoid(a * y + b).reshape(n, 1, 1, c)
    return (xf * g).to(x.dtype)


def _check_cuda_args(x, w, a, b):
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be 4-D float32/bfloat16 NHWC, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous (the permute(0, 2, 3, 1)"
                         " view of a channels_last NCHW tensor)")
    n, h, wd, c = x.shape
    if not 1 <= n <= 65535 or h * wd == 0 or c == 0:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    for name, t, shape in (("w", w, (c, 2)), ("a", a, (c,)), ("b", b, (c,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@functools.cache
def _lib():
    lib = load("selfnorm")
    fn = lib.cnsn_selfnorm_infer
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def selfnorm_infer_cuda(x, w, a, b, eps: float = 1e-12):
    """Launch the CUDA kernel on the current stream; raise on a refused
    launch.  Arguments as for ``selfnorm_infer_reference`` (ddof is 1)."""
    _check_cuda_args(x, w, a, b)
    fn = _lib()
    n, h, wd, c = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), n, h * wd, c,
                 eps, stream)
    if err != 0:
        raise RuntimeError(f"selfnorm_infer kernel launch failed: "
                           f"cudaError {err}")
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
