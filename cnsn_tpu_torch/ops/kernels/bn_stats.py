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

The backward is one streaming pass whose plan, ``bn_bwd_plan``, is a pure
function of the shape and the card, so the CPU tests check it at every
model shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LAUNCHES
from ._launch import (DTYPE_CODE, INT, PTR, bind, check_activation,
                      check_f32, check_launch, device_limits, stream,
                      vector_width)

__all__ = ["BnSums", "bn_bwd_plan", "bn_sums_bwd_cuda",
           "bn_sums_bwd_reference", "bn_sums_cuda", "bn_sums_plan",
           "bn_sums_reference"]


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
    return (bind("bn_stats", "cnsn_bn_sums_plan", INT, INT, INT, INT, INT,
                 ctypes.POINTER(ctypes.c_int)),
            bind("bn_stats", "cnsn_bn_sums", INT, INT, PTR, PTR, PTR, PTR,
                 INT, PTR, PTR, INT, INT, INT, INT, INT, PTR),
            bind("bn_stats", "cnsn_bn_sums_bwd", INT, INT, PTR, PTR, PTR,
                 PTR, PTR, INT, INT, INT, INT, INT, PTR),
            bind("bn_stats", "cnsn_bn_sums_bwd_occupancy", INT, INT,
                 ctypes.POINTER(ctypes.c_int)))


_PLAN_KEYS = ("chunks", "ctiles", "blocks_per_sm", "tile", "cluster")


@functools.lru_cache(maxsize=256)
def _plan(device: int, dtype: int, vec: int, rows: int, c: int,
          chunks: int) -> tuple:
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(device):
        err = _kernels()[0](dtype, vec, rows, c, chunks, out)
    if err != 0:
        raise RuntimeError(f"bn_sums: no plan for {rows} rows x {c} "
                           f"(cudaError {err})")
    return tuple(out)


def bn_sums_plan(x: torch.Tensor, chunks: int = 0) -> dict:
    """The forward kernel's plan for x on its device: row chunks per
    channel tile, channel tiles, resident blocks per SM, channels per tile
    and blocks per cluster (``chunks`` > 0 forces the chunk count, as
    sweeps run it)."""
    c = x.shape[-1]
    return dict(zip(_PLAN_KEYS, _plan(x.device.index, DTYPE_CODE[x.dtype],
                                      vector_width(x), x.numel() // c, c,
                                      chunks)))


# The forward's ticket counters, one zeroed int32 buffer per (device,
# stream): a kernel leaves its counters at 0, calls on one stream run in
# order, and two streams never share a buffer.
_TICKETS: dict = {}


def _tickets(x: torch.Tensor, n: int) -> torch.Tensor:
    key = (x.device.index, stream(x))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=x.device)
        _TICKETS[key] = buf
    return buf


def bn_sums_cuda(x: torch.Tensor, m0: torch.Tensor):
    """Launch the forward kernel on the current stream; raise on a
    refused launch.  x is contiguous with C last (an NHWC activation);
    arguments and results as for ``bn_sums_reference``."""
    s1, s2 = _launch(x, m0)
    LAUNCHES["bn_sums"] += 1
    return s1, s2


def _launch(x: torch.Tensor, m0: torch.Tensor, chunks: int = 0,
            finish: bool = True):
    """One launch of the forward kernel, not counted (sweeps and the card
    tests force a plan through it): ``chunks`` > 0 forces the plan's
    chunk count; ``finish=False`` stops the kernel at its partials and
    returns them, (2, partials, C) fp64, instead of (s1, s2)."""
    check_activation(x)
    c = x.shape[-1]
    rows = x.numel() // c
    check_f32(x, "m0", m0, (c,))
    vec = vector_width(x)
    plan = bn_sums_plan(x, chunks)
    s1 = torch.empty(c, dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty((2, plan["chunks"] // plan["cluster"], c),
                       dtype=torch.float64, device=x.device)
    tickets = _tickets(x, plan["ctiles"])
    with torch.cuda.device(x.device):
        err = _kernels()[1](DTYPE_CODE[x.dtype], vec, x.data_ptr(),
                            m0.data_ptr(), part.data_ptr(),
                            tickets.data_ptr(), tickets.numel(),
                            s1.data_ptr(), s2.data_ptr(), rows, c,
                            plan["chunks"], plan["cluster"], int(finish),
                            stream(x))
    check_launch(err, "bn_sums")
    return (s1, s2) if finish else part


# The backward kernel's constants (csrc/bn_stats.cu)
BWD_THREADS = 256
BWD_BLOCKS_PER_SM = 4  # kBwdBlocksPerSm, the residency its registers allow
BWD_UNROLL = 4         # kBwdUnroll: 16-byte loads in flight a thread


def bn_bwd_plan(rows: int, c: int, dtype: torch.dtype, vec: int, sms: int,
                chunks: int = 0) -> dict:
    """The backward's launch for x of (rows, c) in ``dtype`` loaded ``vec``
    elements a thread on a card of ``sms`` SMs: a pure function.

    ``lanes`` threads (up to a whole block) span a tile of ``lanes · vec``
    channels, ``BWD_THREADS // lanes`` rows a step; each tile's rows go to
    ``chunks`` blocks of ``chunk_rows`` contiguous rows, as many as fill
    one wave of resident blocks with at least one unrolled step
    (``BWD_UNROLL`` row steps) a thread, and no block empty.
    ``chunks`` > 0 forces the blocks per tile (sweeps)."""
    if vec not in (1, 16 // dtype.itemsize):
        raise ValueError(f"no {dtype} kernel loads {vec} elements")
    lanes = min(-(-c // vec), BWD_THREADS)
    tile = lanes * vec
    ctiles = -(-c // tile)
    step = BWD_THREADS // lanes
    steps = -(-rows // step)
    wave = sms * BWD_BLOCKS_PER_SM
    if chunks < 1:
        chunks = max(1, min(wave // ctiles, -(-steps // BWD_UNROLL)))
    chunk_steps = -(-steps // min(chunks, steps))
    chunks = -(-steps // chunk_steps)
    return {"lanes": lanes, "tile": tile, "ctiles": ctiles, "step": step,
            "chunks": chunks, "chunk_rows": chunk_steps * step,
            "blocks": chunks * ctiles, "wave": wave}


def bn_bwd_plan_of(x: torch.Tensor, chunks: int = 0) -> dict:
    """``bn_bwd_plan`` for x (C last) on its card."""
    c = x.shape[-1]
    return bn_bwd_plan(x.numel() // c, c, x.dtype, vector_width(x),
                       device_limits(x.device)[0], chunks)


def bn_bwd_occupancy(x: torch.Tensor) -> int:
    """The backward kernel's resident blocks per SM for x's type and
    vector width on its card."""
    out = ctypes.c_int()
    with torch.cuda.device(x.device):
        err = _kernels()[3](DTYPE_CODE[x.dtype], vector_width(x),
                            ctypes.byref(out))
    check_launch(err, "bn_sums_bwd occupancy")
    return out.value


def bn_sums_bwd_cuda(x, m0, g1, g2):
    """Launch the backward kernel on the current stream; raise on a
    refused launch.  Arguments and result as for
    ``bn_sums_bwd_reference``; m0, g1 and g2 are contiguous (C,) fp32."""
    dx = _launch_bwd(x, m0, g1, g2)
    LAUNCHES["bn_sums_bwd"] += 1
    return dx


def _launch_bwd(x, m0, g1, g2, chunks: int = 0):
    """One launch of the backward kernel, not counted (sweeps force a
    plan through it)."""
    check_activation(x)
    c = x.shape[-1]
    for name, t in (("m0", m0), ("g1", g1), ("g2", g2)):
        check_f32(x, name, t, (c,))
    plan = bn_bwd_plan_of(x, chunks)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernels()[2](DTYPE_CODE[x.dtype], vector_width(x),
                            x.data_ptr(), m0.data_ptr(), g1.data_ptr(),
                            g2.data_ptr(), dx.data_ptr(), x.numel() // c, c,
                            plan["lanes"], plan["chunks"],
                            plan["chunk_rows"], stream(x))
    check_launch(err, "bn_sums_bwd")
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
