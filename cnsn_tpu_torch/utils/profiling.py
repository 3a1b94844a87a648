"""Profiling: where a forward's device time goes.  Port of
``cnsn_tpu/utils/profiling.py`` (trace capture), on ``torch.profiler``.

``device_time_breakdown`` runs a callable a few times under the profiler
and sums the device time of every kernel by name and by family (conv /
GEMM, batch norm, each of the port's kernels, elementwise, ...), with
each family's launches, beside the busy time of the device (the union of
kernel intervals) and the host's wall time of the window, whose
difference is the device's idle share.  A window's kernels are counted
by correlation id against the host's launches, so a record the card's
trace lost raises instead of being miscounted (``window_kernels``).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, NamedTuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

__all__ = ["Kernel", "LostRecords", "device_time_breakdown",
           "kernel_family", "window", "window_kernels"]

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


# torch.cuda._sleep's kernel: the markers that open a profiled window
_MARK, _MARK_CYCLES, _MARKS = "spin_kernel", 1000, 8
# the host's records of a kernel launch (runtime and driver API), and of
# any call that puts work on the card (a launch, a copy or a fill)
_LAUNCH = ("cudaLaunch", "cuLaunch")
_WORK = _LAUNCH + ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
# profiles a breakdown takes before a lost record raises
_ATTEMPTS = 3
_ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


class Kernel(NamedTuple):
    """A kernel (or copy) the card ran, on the profile's clock (µs)."""
    name: str
    start_us: float
    end_us: float


class LostRecords(RuntimeError):
    """A profile lost the card's record of a launch in its window."""


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
def window(fn: Callable[[], object]) -> Iterator[profile]:
    """A profile of one window: the card's activity tracing is switched on
    in a warmup step (one untimed call of ``fn``, nothing kept), then the
    active step records ``_MARKS`` marker kernels back to back and the
    block's calls; yields the profiler, which ``window_kernels`` reads
    once the block is done.  (A profile without the warmup step loses the
    card's records of its first launches: ``utils/profile_probe.py``.)"""
    with profile(activities=_ACTIVITIES,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(_MARKS):
            torch.cuda._sleep(_MARK_CYCLES)
        yield prof
        torch.cuda.synchronize()


def _events(prof) -> list:
    result = getattr(prof.profiler, "kineto_results", None)
    return list(result.events()) if result is not None else []


def window_kernels(prof) -> list:
    """The card's kernels, copies and fills (``Kernel``) of ``window``'s
    block, matched by correlation id to the host's calls that put them
    there.  The window is read on the host, whose record of a launch the
    profile keeps where the card's may go: its first ``_MARKS`` launches
    are the markers (the card's records of them, those that are left,
    must be among these), and the block's calls are those whose id
    follows the last marker's.  The card's other records (the profiler's
    step annotation) are not the block's work.  Raises ``LostRecords``
    where the markers do not open the window, and where a kernel the
    block launched has no record on the card."""
    events = _events(prof)
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    marks = {e.correlation_id() for e in device if _MARK in e.name()}
    host = sorted((e.correlation_id(), e.name()) for e in events
                  if e.device_type() == DeviceType.CPU
                  and e.name().startswith(_WORK))
    launches = [(c, name) for c, name in host if name.startswith(_LAUNCH)]
    opening = {c for c, _ in launches[:_MARKS]}
    if len(opening) < _MARKS or not marks <= opening:
        raise LostRecords(
            f"the profile holds no window marker where its window opens "
            f"({len(launches)} kernel launches on the host, markers on the "
            f"card at {sorted(marks)[:_MARKS]}; {len(device)} records on "
            f"the card: {[e.name()[:40] for e in device[:6]]})")
    last = max(opening)
    work = {c for c, _ in host if c > last}
    kept = [e for e in device if e.correlation_id() in work]
    seen = {e.correlation_id() for e in kept}
    lost = [name for c, name in launches if c > last and c not in seen]
    if lost:
        raise LostRecords(
            f"the profile lost the card's record of {len(lost)} of the "
            f"window's {sum(c > last for c, _ in launches)} launches "
            f"({lost[:4]})")
    return [Kernel(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in sorted(kept, key=lambda e: e.start_ns())]


def device_time_breakdown(fn: Callable[[], object], iters: int = 5,
                          warmup: int = 2, top: int = 10) -> Dict:
    """Per-call device milliseconds of ``fn`` by kernel family (and the
    family's launches per call) and for the ``top`` kernels by name, the
    device's busy time, the host's wall time and the idle share
    ``1 − busy/wall``, over ``iters`` calls (after ``warmup`` calls, and
    one more in the profile's warmup step: ``window``).  A profile that
    lost a record of its window is taken again, so ``fn`` runs again,
    up to ``_ATTEMPTS`` profiles in all (``attempts`` in the result),
    then raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, _ATTEMPTS + 1):
        with window(fn) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        try:
            kernels = window_kernels(prof)
            break
        except LostRecords:
            if attempt == _ATTEMPTS:
                raise
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    intervals = []
    for k in kernels:
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
        "iters": iters, "attempts": attempt,
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
