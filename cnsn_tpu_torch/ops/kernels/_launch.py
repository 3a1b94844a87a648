"""What every kernel wrapper does around a launch: check its arguments
against what the kernel takes (raising on anything else), bind the C
functions of a library, and raise on a refused launch."""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load

__all__ = ["DTYPE_CODE", "bind", "check_activation", "check_f32",
           "check_launch", "device_limits", "stream", "vector_width"]

# dtype codes of the kernels' C interfaces
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(library: str, function: str, *argtypes):
    """A C function of ``csrc/<library>.cu`` (built at first use) with its
    argument types declared; every one returns an int."""
    fn = getattr(load(library), function)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_activation(x: torch.Tensor, ndim: int | None = None) -> None:
    """x: a CUDA float32/bfloat16 tensor, contiguous with C last (for a
    model activation, the permute(0, 2, 3, 1) view of a channels_last
    NCHW tensor), no dimension empty."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODE or (ndim is not None and x.dim() != ndim):
        want = f"{ndim}-D " if ndim is not None else ""
        raise ValueError(f"x must be {want}float32/bfloat16 NHWC, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous (the permute(0, 2, 3, 1)"
                         " view of a channels_last NCHW tensor)")
    if x.dim() < 2 or x.numel() == 0 or x.numel() // x.shape[-1] >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")


def check_f32(x: torch.Tensor, name: str, t: torch.Tensor, shape) -> None:
    """t: a contiguous float32 tensor of ``shape`` on x's device."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape {tuple(shape)}, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def vector_width(x: torch.Tensor) -> int:
    """Elements a thread loads at once: one 16-byte vector where the
    channel count and x's address allow it, else 1."""
    v = 16 // x.element_size()
    return v if x.shape[-1] % v == 0 and x.data_ptr() % 16 == 0 else 1


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> tuple:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_multiprocessor


def device_limits(device: torch.device) -> tuple:
    """(SMs, shared memory bytes per SM) of a CUDA device: what the
    kernels' plans are sized from."""
    return _limits(torch.device(device).index or 0)


def stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as the C functions take it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_launch(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
