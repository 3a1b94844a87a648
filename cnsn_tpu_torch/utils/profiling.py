"""Profiling: where a forward's device time goes.  Port of
``cnsn_tpu/utils/profiling.py`` (trace capture), on ``torch.profiler``.

``device_time_breakdown`` runs a callable a few times under the profiler
and sums the device time of every kernel by name and by family (conv /
GEMM, batch norm, each of the port's kernels, elementwise, ...), beside the busy
time of the device (the union of kernel intervals) and the host's wall
time of the window, whose difference is the device's idle share.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["device_time_breakdown", "kernel_family"]

# (family, substrings of the kernel name), first match wins
_FAMILIES = (
    ("selfnorm", ("selfnorm",)),                     # K3
    ("ins_stats_bwd", ("ins_bwd_kernel",)),          # K1 backward
    ("ins_stats", ("ins_sums_kernel", "ins_finalize_kernel")),  # K1
    ("bn_stats_bwd", ("bn_bwd_kernel",)),            # K2 backward
    ("bn_stats", ("bn_sums_kernel", "bn_finalize_kernel")),     # K2
    ("conv_wgrad3x3", ("wgrad3x3_",)),               # K4, before cuDNN's wgrad
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_infer")),
    ("pool", ("pool",)),
    ("conv_gemm", ("conv", "gemm", "xmma", "cutlass", "implicit", "fprop",
                   "dgrad", "wgrad", "cudnn", "sm90_", "nvjet")),
    ("optimizer", ("multi_tensor",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "copy")),
    ("memcpy_memset", ("memcpy", "memset")),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, keys in _FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_time_breakdown(fn: Callable[[], object], iters: int = 5,
                          warmup: int = 2, top: int = 10) -> Dict:
    """Per-call device milliseconds of ``fn`` by kernel family and for the
    ``top`` kernels by name, the device's busy time, the host's wall time
    and the idle share ``1 − busy/wall``, over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    intervals = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        by_name[evt.name] += e - s
        launches[evt.name] += 1
    by_family: Dict[str, float] = defaultdict(float)
    for name, us in by_name.items():
        by_family[kernel_family(name)] += us
    busy_us = _union_us(intervals)
    per_call_ms = 1e-3 / iters
    top_names = sorted(by_name, key=by_name.get, reverse=True)[:top]
    return {
        "iters": iters,
        "wall_ms": wall_us * per_call_ms,
        "device_busy_ms": busy_us * per_call_ms,
        "device_idle_share": (1.0 - busy_us / wall_us) if wall_us else None,
        "kernels_per_call": sum(launches.values()) / iters,
        "by_family_ms": {k: v * per_call_ms for k, v in
                         sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [{"name": n[:96], "ms": by_name[n] * per_call_ms,
                            "launches": launches[n] / iters}
                           for n in top_names],
    }
