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

The forward is one launch and the backward one streaming pass; their
plans, ``ins_stats_plan`` and ``ins_bwd_plan``, are pure functions of the
shape and the card, so the CPU tests check them at every model shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LAUNCHES
from ._launch import (DTYPE_CODE, FLOAT, INT, PTR, bind, check_activation,
                      check_f32, check_launch, device_limits, stream,
                      vector_width)

__all__ = ["InsStats", "ins_bwd_plan", "ins_stats_bwd_cuda",
           "ins_stats_bwd_reference", "ins_stats_cuda", "ins_stats_plan",
           "ins_stats_reference"]


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
    return (bind("ins_stats", "cnsn_ins_stats_occupancy", INT, INT,
                 ctypes.POINTER(ctypes.c_int)),
            bind("ins_stats", "cnsn_ins_stats", INT, INT, PTR, PTR, PTR, INT,
                 INT, INT, INT, INT, INT, FLOAT, INT, PTR),
            bind("ins_stats", "cnsn_ins_stats_bwd", INT, INT, PTR, PTR, PTR,
                 PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, PTR),
            bind("ins_stats", "cnsn_ins_stats_bwd_occupancy", INT, INT,
                 ctypes.POINTER(ctypes.c_int)))


# The forward kernel's constants (csrc/ins_stats.cu)
THREADS = 256
BLOCKS_PER_SM = 4   # kFwdBlocksPerSm, the residency its registers allow
UNROLL = {1: 16, 4: 8, 8: 8}  # kUnrollOne / kUnroll: loads in flight
MAX_CLUSTER = 8     # kCluster, the portable cluster size
# A plane's blocks double while each keeps this many unrolled load steps
# a thread (or while the card holds fewer blocks than SMs): a doubling
# cost ~1.4 us on the card at WRN-40-2's shapes (PERF.md).
MIN_BATCHES = 16
_SMEM_RESERVED = 1024  # shared memory the card holds back per block


def ins_stats_plan(n: int, hw: int, c: int, dtype: torch.dtype, vec: int,
                   sms: int, smem_per_sm: int, split: int = 0,
                   lanes: int = 0) -> dict:
    """The forward's launch for x of (n, hw, c) in ``dtype`` loaded ``vec``
    elements a thread, on a card of ``sms`` SMs with ``smem_per_sm`` bytes
    of shared memory each: a pure function.

    ``lanes`` threads (a power of two up to ``THREADS``, as few as span C)
    cover a tile of ``lanes · vec`` channels, ``THREADS / lanes`` rows a
    step; each (sample, tile) plane goes to one cluster of ``split``
    blocks of ``chunk_rows`` rows, which add over distributed shared
    memory.  ``split`` doubles, up to ``MAX_CLUSTER`` and within one wave
    of resident blocks (``blocks_per_sm`` · ``sms``), while the grid holds
    fewer blocks than SMs or each block keeps ``MIN_BATCHES`` unrolled
    load steps a thread.  ``split`` > 0 forces the blocks per plane
    (rounded down to a power of two up to ``MAX_CLUSTER``) and ``lanes`` >
    0 (a power of two up to ``THREADS``) the lanes (sweeps, tests)."""
    if vec not in (1, 16 // dtype.itemsize):
        raise ValueError(f"no {dtype} kernel loads {vec} elements")
    if lanes < 1:
        lanes = min(THREADS, 1 << (-(-c // vec) - 1).bit_length())
    elif lanes > THREADS or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two up to {THREADS}")
    tile = lanes * vec
    ctiles = -(-c // tile)
    step = THREADS // lanes
    steps = -(-hw // step)
    planes = n * ctiles
    batches = -(-steps // UNROLL[vec])
    smem = 2 * THREADS * vec * 8  # red, in fp64
    blocks_per_sm = min(BLOCKS_PER_SM, smem_per_sm // (smem + _SMEM_RESERVED))
    wave = sms * blocks_per_sm
    if split < 1:
        split = 1
        while (2 * split <= MAX_CLUSTER and 2 * split * planes <= wave
               and (2 * split * planes <= sms
                    or batches >= 2 * split * MIN_BATCHES)):
            split *= 2
    split = 1 << (min(split, MAX_CLUSTER).bit_length() - 1)
    return {"lanes": lanes, "tile": tile, "ctiles": ctiles, "step": step,
            "split": split, "batches": batches,
            "chunk_rows": -(-steps // split) * step,
            "blocks": planes * split, "blocks_per_sm": blocks_per_sm,
            "wave": wave}


def ins_stats_plan_of(x: torch.Tensor, split: int = 0,
                      lanes: int = 0) -> dict:
    """``ins_stats_plan`` for x (NHWC) on its card."""
    n, h, w, c = x.shape
    sms, smem_per_sm = device_limits(x.device)
    return ins_stats_plan(n, h * w, c, x.dtype, vector_width(x), sms,
                          smem_per_sm, split=split, lanes=lanes)


def ins_stats_occupancy(x: torch.Tensor) -> dict:
    """The forward kernel's residency for x's type and vector width on its
    card: blocks per SM, and clusters of 8 on the card."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(x.device):
        err = _kernels()[0](DTYPE_CODE[x.dtype], vector_width(x), out)
    check_launch(err, "ins_stats occupancy")
    return {"blocks_per_sm": out[0], "clusters": out[1]}


def _check_x(x):
    check_activation(x, ndim=4)
    if x.shape[0] > 65535 or x.shape[0] * x.shape[3] >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")


def ins_stats_cuda(x: torch.Tensor, eps: float = 1e-5, ddof: int = 1):
    """Launch the forward kernel on the current stream; raise on a refused
    launch.  Arguments and results as for ``ins_stats_reference``."""
    mean, std = _launch(x, eps, ddof)
    LAUNCHES["ins_stats"] += 1
    return mean, std


def _launch(x: torch.Tensor, eps: float = 1e-5, ddof: int = 1,
            split: int = 0, lanes: int = 0):
    """One launch of the forward kernel, not counted (sweeps and the card
    tests force a plan through it): ``split`` > 0 forces the blocks per
    plane, ``lanes`` > 0 the lanes."""
    _check_x(x)
    if ddof < 0:
        raise ValueError(f"ddof must be >= 0, got {ddof}")
    n, h, w, c = x.shape
    plan = ins_stats_plan_of(x, split, lanes)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    std = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _kernels()[1](
            DTYPE_CODE[x.dtype], vector_width(x), x.data_ptr(),
            mean.data_ptr(), std.data_ptr(), n, h * w, c, plan["lanes"],
            plan["split"], plan["chunk_rows"], eps, ddof, stream(x))
    check_launch(err, "ins_stats")
    return mean, std


# The backward kernel's constants (csrc/ins_stats.cu)
BWD_BLOCKS_PER_SM = 4  # kBwdBlocksPerSm, the residency its registers allow
BWD_UNROLL = 2         # kBwdUnroll: loads in flight a thread


def ins_bwd_plan(n: int, hw: int, c: int, dtype: torch.dtype, vec: int,
                 sms: int, chunks: int = 0) -> dict:
    """The backward's launch for x of (n, hw, c) in ``dtype`` loaded
    ``vec`` elements a thread on a card of ``sms`` SMs: a pure function.

    ``lanes`` threads (a power of two up to ``THREADS``, as few as span C)
    cover a tile of ``lanes · vec`` channels, ``THREADS // lanes`` rows a
    step; each (sample, tile) plane's rows go to ``chunks`` blocks of
    ``chunk_rows`` contiguous rows, as many as fill one wave of resident
    blocks with at least one unrolled step (``BWD_UNROLL`` row steps) a
    thread, and no block empty.  ``chunks`` > 0 forces the blocks per
    plane (sweeps, tests)."""
    if vec not in (1, 16 // dtype.itemsize):
        raise ValueError(f"no {dtype} kernel loads {vec} elements")
    lanes = min(THREADS, 1 << (-(-c // vec) - 1).bit_length())
    tile = lanes * vec
    ctiles = -(-c // tile)
    step = THREADS // lanes
    steps = -(-hw // step)
    planes = n * ctiles
    wave = sms * BWD_BLOCKS_PER_SM
    if chunks < 1:
        chunks = max(1, min(wave // planes, -(-steps // BWD_UNROLL)))
    chunk_steps = -(-steps // min(chunks, steps))
    chunks = -(-steps // chunk_steps)
    return {"lanes": lanes, "tile": tile, "ctiles": ctiles, "step": step,
            "chunks": chunks, "chunk_rows": chunk_steps * step,
            "blocks": chunks * planes, "wave": wave}


def ins_bwd_plan_of(x: torch.Tensor, chunks: int = 0) -> dict:
    """``ins_bwd_plan`` for x (NHWC) on its card."""
    n, h, w, c = x.shape
    return ins_bwd_plan(n, h * w, c, x.dtype, vector_width(x),
                        device_limits(x.device)[0], chunks)


def ins_bwd_occupancy(x: torch.Tensor) -> int:
    """The backward kernel's resident blocks per SM for x's type and
    vector width on its card."""
    out = ctypes.c_int()
    with torch.cuda.device(x.device):
        err = _kernels()[3](DTYPE_CODE[x.dtype], vector_width(x),
                            ctypes.byref(out))
    check_launch(err, "ins_stats_bwd occupancy")
    return out.value


def ins_stats_bwd_cuda(x, mean, std, gm, gs, ddof: int = 1):
    """Launch the backward kernel on the current stream; raise on a refused
    launch.  Arguments and result as for ``ins_stats_bwd_reference``;
    mean, std, gm and gs are contiguous (N, C) fp32."""
    dx = _launch_bwd(x, mean, std, gm, gs, ddof)
    LAUNCHES["ins_stats_bwd"] += 1
    return dx


def _launch_bwd(x, mean, std, gm, gs, ddof: int = 1, chunks: int = 0):
    """One launch of the backward kernel, not counted (sweeps and the
    card tests force a plan through it): ``chunks`` > 0 forces the blocks
    per plane."""
    _check_x(x)
    if ddof < 0:
        raise ValueError(f"ddof must be >= 0, got {ddof}")
    n, h, w, c = x.shape
    for name, t in (("mean", mean), ("std", std), ("gm", gm), ("gs", gs)):
        check_f32(x, name, t, (n, c))
    plan = ins_bwd_plan_of(x, chunks)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernels()[2](DTYPE_CODE[x.dtype], vector_width(x),
                            x.data_ptr(), mean.data_ptr(), std.data_ptr(),
                            gm.data_ptr(), gs.data_ptr(), dx.data_ptr(), n,
                            h * w, c, ddof, plan["lanes"], plan["chunks"],
                            plan["chunk_rows"], stream(x))
    check_launch(err, "ins_stats_bwd")
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
