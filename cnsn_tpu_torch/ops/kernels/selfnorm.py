"""K3: fused eval-mode SelfNorm, one read and one write of x.

Port of ``cnsn_tpu/ops/pallas/selfnorm.py``.  The TPU kernel
``selfnorm_infer_pallas`` becomes two hand-written CUDA kernels in
``cnsn_tpu_torch/csrc/selfnorm.cu`` (its header states the designs and the
bound): ``staged``, which brings each (sample, channel tile) plane into
shared memory once, a cluster of up to 8 blocks splitting its rows, on
the plan the C code sets for the card (``selfnorm_plan`` reports it); and
the first port's ``v1`` kernel for every other call.  ``selfnorm_path`` is the rule between them;
``selfnorm_infer_reference`` is their plain PyTorch version.

``selfnorm_infer`` is the op the model calls.  It is registered as
``torch.ops.cnsn_tpu_torch.selfnorm_infer`` so that ``torch.export`` keeps
it as one node: on a CPU tensor it runs the plain version, on a CUDA
tensor it launches the kernel ``selfnorm_path`` picks (or raises), and on
any other device it raises.

Layout: x is NHWC, as in the JAX package.  The model's activations are
NCHW tensors in ``torch.channels_last`` memory; their ``permute(0, 2, 3,
1)`` view is NHWC-contiguous and is what the model passes, at no copy.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LAUNCHES, watch
from ._launch import (DTYPE_CODE, FLOAT, INT, PTR, bind, check_activation,
                      check_f32, check_launch, stream)
from .ins_stats import ins_stats_reference

__all__ = ["selfnorm_infer", "selfnorm_infer_cuda",
           "selfnorm_infer_reference", "selfnorm_path", "selfnorm_plan"]

# the C interface's path codes, and the LAUNCHES key of each path's kernel
PATHS = {"v1": (0, "selfnorm_infer"), "staged": (1, "selfnorm_infer_staged")}


def selfnorm_infer_reference(x, w, a, b, eps: float = 1e-12, ddof: int = 1):
    """Plain version.  x: NHWC f32/bf16; w: (C, 2) g_fc weight; a, b: (C,)
    the folded BN-eval affine  a = scale/sqrt(rv+eps_bn),  b = bias − a·rm.

    Rounds as the Pallas kernel does: x·g is taken in fp32 and then cast
    to x's type.  (The JAX jnp eval path casts g to bf16 before the
    product, so in bf16 the two JAX paths differ by up to 1 ulp; the port
    follows the kernel.)  A float64 x (the CPU parity tests) is taken in
    float64 throughout.
    """
    n, _, _, c = x.shape
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, std = ins_stats_reference(xf, eps=eps, ddof=ddof)
    y = w[:, 0] * mean + w[:, 1] * std
    g = torch.sigmoid(a * y + b).reshape(n, 1, 1, c)
    return (xf * g).to(x.dtype)


@functools.cache
def _kernels():
    return (bind("selfnorm", "cnsn_selfnorm_plan", INT, INT, INT, INT,
                 ctypes.POINTER(ctypes.c_int)),
            bind("selfnorm", "cnsn_selfnorm_infer", INT, INT, INT, INT, PTR,
                 PTR, PTR, PTR, PTR, INT, INT, INT, FLOAT, PTR))


_PLAN_KEYS = ("lanes", "cluster", "rows", "smem_bytes", "blocks")


@functools.lru_cache(maxsize=1024)
def _plan(device: int, dtype: int, n: int, hw: int, c: int) -> tuple:
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(device):
        err = _kernels()[0](dtype, n, hw, c, out)
    if err != 0:
        raise RuntimeError(f"selfnorm: no plan for {(n, hw, c)} "
                           f"(cudaError {err})")
    return tuple(out)


def selfnorm_plan(x: torch.Tensor) -> dict | None:
    """The staged kernel's plan for a CUDA x (N, H, W, C) on its card, as
    ``csrc/selfnorm.cu::staged_plan`` sets it: ``lanes`` of 16 bytes
    across a tile of ``tile`` channels, ``cluster`` blocks splitting a
    sample's H·W rows, ``rows`` staged by a block, its ``smem_bytes`` and
    the grid's ``blocks``.  None where the kernel cannot stage x's planes
    (C not a multiple of one 16-byte vector, or a plane too large for a
    cluster of 8)."""
    n, h, w, c = x.shape
    plan = dict(zip(_PLAN_KEYS, _plan(x.device.index, DTYPE_CODE[x.dtype],
                                      n, h * w, c)))
    if plan["lanes"] == 0:
        return None
    plan["tile"] = plan["lanes"] * 16 // x.element_size()
    return plan


def selfnorm_path(x: torch.Tensor) -> str:
    """Which kernel takes the call: ``"staged"`` for a float32 or bfloat16
    NHWC-contiguous x whose C is a multiple of one 16-byte vector (4 fp32,
    8 bf16) and whose address is 16-byte aligned, where (on the card) its
    planes fit a cluster (``selfnorm_plan``); ``"v1"`` for every other
    call."""
    if (x.dtype not in DTYPE_CODE or x.dim() != 4 or not x.is_contiguous()
            or x.data_ptr() % 16 or x.shape[-1] % (16 // x.element_size())):
        return "v1"
    if x.device.type == "cuda" and selfnorm_plan(x) is None:
        return "v1"
    return "staged"


def selfnorm_infer_cuda(x, w, a, b, eps: float = 1e-12,
                        path: str | None = None):
    """Launch a CUDA kernel on the current stream; raise on a refused
    launch.  Arguments as for ``selfnorm_infer_reference`` (ddof is 1).
    ``path`` forces a kernel (to time or check one against the other at
    the same shape); by default ``selfnorm_path`` chooses, and a forced
    ``staged`` that the call does not allow raises."""
    check_activation(x, ndim=4)
    n, h, wd, c = x.shape
    if n > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    for name, t, shape in (("w", w, (c, 2)), ("a", a, (c,)), ("b", b, (c,))):
        check_f32(x, name, t, shape)
    return _launch(x, w, a, b, eps, path or selfnorm_path(x))


def _launch(x, w, a, b, eps: float, path: str, lanes: int = 0,
            cluster: int = 0):
    """One launch of ``path``'s kernel, counted; raises on a refused
    launch.  The staged kernel takes its plan, or (sweeps) the forced
    ``lanes`` and ``cluster``."""
    code, key = PATHS[path]
    n, h, wd, c = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernels()[1](DTYPE_CODE[x.dtype], code, lanes, cluster,
                            x.data_ptr(), w.data_ptr(), a.data_ptr(),
                            b.data_ptr(), out.data_ptr(), n, h * wd, c, eps,
                            stream(x))
    check_launch(err, key)
    LAUNCHES[key] += 1
    watch(key, out)
    return out


@torch.library.custom_op("cnsn_tpu_torch::selfnorm_infer", mutates_args=(),
                         device_types="cpu")
def selfnorm_infer(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Fused eval SelfNorm: the plain version on CPU tensors, the CUDA
    kernel on CUDA tensors.  Arguments as for
    ``selfnorm_infer_reference`` (ddof is 1)."""
    return selfnorm_infer_reference(x, w, a, b, eps)


@selfnorm_infer.register_kernel("cuda")
def _(x, w, a, b, eps=1e-12):
    return selfnorm_infer_cuda(x, w, a, b, eps)


@selfnorm_infer.register_fake
def _(x, w, a, b, eps=1e-12):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
