"""Profiling: where a forward's device time goes.  Port of
``cnsn_tpu/utils/profiling.py`` (trace capture), on ``torch.profiler``.

``device_time_breakdown`` runs a callable a few times under the profiler
and sums the device time of every kernel by name and by family (conv /
GEMM, batch norm, each of the port's kernels, elementwise, ...), with
each family's launches, beside the busy time of the device (the union of
kernel intervals) and the host's wall time of the window, whose
difference is the device's idle share.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, NamedTuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["Kernel", "device_time_breakdown", "kernel_family", "window",
           "window_kernels"]

# (family, substrings of the kernel name), first match wins
_FAMILIES = (
    ("selfnorm", ("selfnorm",)),         # K3: staged and v1 kernels
    # K1 backward (ins_bwd_stream_kernel; the first port's ins_bwd_kernel)
    ("ins_stats_bwd", ("ins_bwd_",)),
    ("ins_stats", ("ins_stats_cluster_kernel",)),    # K1 forward
    ("bn_stats_bwd", ("bn_bwd_stream_kernel",)),     # K2 backward
    # K2 forward (bn_sums_persistent_kernel; the two-launch design's
    # bn_sums_kernel and bn_finalize_kernel), before batch_norm's "bn_fw"
    ("bn_stats", ("bn_sums_", "bn_finalize_kernel")),
    # K4's wmma, wgmma and narrow kernels and their sums, before cuDNN's
    # wgrad
    ("conv_wgrad3x3", ("wgrad3x3_",)),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_infer")),
    ("pool", ("pool",)),
    ("conv_gemm", ("conv", "gemm", "xmma", "cutlass", "implicit", "fprop",
                   "dgrad", "wgrad", "cudnn", "sm90_", "nvjet")),
    ("optimizer", ("multi_tensor",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "copy")),
    ("memcpy_memset", ("memcpy", "memset")),
)


# torch.cuda._sleep's kernel: the markers before a profiled window, and
# how many: more than a profile's first records that go missing
_MARK, _MARK_CYCLES, _MARKS = "spin_kernel", 1000, 8


class Kernel(NamedTuple):
    """A kernel (or copy) the card ran, on the profile's clock (µs)."""
    name: str
    start_us: float
    end_us: float


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


@contextlib.contextmanager
def window(fn: Callable[[], object]) -> Iterator[Callable[[], object]]:
    """Inside a running profiler: one untimed call of ``fn``, then
    ``_MARKS`` marker kernels back to back; the block runs the window (the
    yielded ``fn``), and ``window_kernels`` counts the kernels after the
    last marker.  A profile loses the card's records of its first one or
    two launches, whatever the time they take (``utils/profile_probe.py``
    shows it): the untimed call and the markers absorb them, and a
    profile with no marker left raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(_MARKS):
        torch.cuda._sleep(_MARK_CYCLES)
    torch.cuda.synchronize()
    yield fn


def window_kernels(prof) -> list:
    """The card's kernels and copies (``Kernel``) of a profile after the
    last of ``window``'s markers; raises where no marker is left."""
    events = [evt for evt in prof.events()
              if evt.device_type == DeviceType.CUDA]
    marks = [evt.time_range.end for evt in events if _MARK in evt.name]
    if not marks:
        raise RuntimeError(
            f"the profile holds no window marker: the card's activity was "
            f"not recorded ({len(events)} of its records left: "
            f"{[evt.name[:40] for evt in events[:6]]})")
    begin = max(marks)
    return [Kernel(evt.name, evt.time_range.start, evt.time_range.end)
            for evt in events
            if evt.time_range.start >= begin and _MARK not in evt.name]


def device_time_breakdown(fn: Callable[[], object], iters: int = 5,
                          warmup: int = 2, top: int = 10) -> Dict:
    """Per-call device milliseconds of ``fn`` by kernel family (and the
    family's launches per call) and for the ``top`` kernels by name, the
    device's busy time, the host's wall time and the idle share
    ``1 − busy/wall``, over ``iters`` calls (after ``warmup`` calls, and
    one more inside the profile that is not counted: ``window``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with window(fn) as run:
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    intervals = []
    for k in window_kernels(prof):
        intervals.append((k.start_us, k.end_us))
        by_name[k.name] += k.end_us - k.start_us
        launches[k.name] += 1
    by_family: Dict[str, float] = defaultdict(float)
    family_launches: Dict[str, int] = defaultdict(int)
    for name, us in by_name.items():
        by_family[kernel_family(name)] += us
        family_launches[kernel_family(name)] += launches[name]
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
        "launches_by_family": {k: family_launches[k] / iters
                               for k in by_family},
        "top_kernels_ms": [{"name": n[:96], "ms": by_name[n] * per_call_ms,
                            "launches": launches[n] / iters}
                           for n in top_names],
    }
