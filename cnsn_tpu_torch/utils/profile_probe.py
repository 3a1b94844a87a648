"""Which launches a short profiled window loses, and where: the probe of
the fault of the profiler that loses the card's records of a window's
first launches.

Runs ``SESSIONS`` torch.profiler sessions back to back for each of two
ways to open a window, each around four calls of K2's forward and of a
torch op, as the card tests profile:

  window  — ``profiling.window``: the untimed call in the warmup step of a
            profiler schedule (the card's activity tracing on, nothing
            kept), then eight marker kernels and the four calls in its
            active step; ``profiling.window_kernels`` counted as well
            (``window_raised``: the sessions where it raised, having found
            a record lost)
  warmup  — the same without the markers

In each session every kernel launch the host made (the event of its
cudaLaunch* or cuLaunch* call) is matched to its kernel on the card by
correlation id; a launch with no kernel was lost.  A lost launch is
classed by where it lies: before the first kernel kept ('head'), after
the last ('tail'), between them ('middle'), or 'all' where none was
kept.  Beside that, each kept kernel's start less its launch's start on
the host: a kernel cannot start before its launch, so a negative gap is
a device clock that the profile maps onto the host's wrongly.

Usage, on a machine with a GPU:

    python -m cnsn_tpu_torch.utils.profile_probe

One JSON line per design: sessions, sessions that lost a launch, lost
launches by class, the smallest and the median launch-to-kernel gap
(µs), and for the first ten sessions that lost one, the host's ms from
the trace's start to each launch lost, and to each of the first four
kept with its gap.
"""
from __future__ import annotations

import collections
import json
import statistics

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from . import profiling

SESSIONS, ITERS = 200, 4
_LAUNCH = profiling._LAUNCH
_ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _window(fn):
    with profiling.window(fn) as prof:
        for _ in range(ITERS):
            fn()
    return prof


def _warmup(fn):
    with profile(activities=_ACTIVITIES,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return prof


def session(prof) -> dict:
    """One profile's launches by class (kept, head, middle, tail, all),
    its launch-to-kernel gaps (µs), the host ms from the trace's start to
    each lost launch ('lost_ms'), and to each of the first four kept with
    its gap ('kept_ms_gap_us')."""
    result = prof.profiler.kineto_results
    events, t0 = result.events(), result.trace_start_ns()
    kernels = {e.correlation_id(): e for e in events
               if e.device_type() == DeviceType.CUDA}
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() == DeviceType.CPU
                      and e.name().startswith(_LAUNCH))
    kept = [i for i, (_, c) in enumerate(launches) if c in kernels]
    out, lost_ms, kept_ms, gaps = collections.Counter(), [], [], []
    for i, (start, corr) in enumerate(launches):
        at_ms = (start - t0) / 1e6
        if corr in kernels:
            out["kept"] += 1
            gaps.append((kernels[corr].start_ns() - start) / 1e3)
            kept_ms.append((at_ms, gaps[-1]))
            continue
        where = ("all" if not kept else "head" if i < kept[0]
                 else "tail" if i > kept[-1] else "middle")
        out[where] += 1
        lost_ms.append(at_ms)
    return {**out, "lost_ms": lost_ms, "kept_ms_gap_us": kept_ms[:4],
            "gaps_us": gaps}


def main() -> list:
    from ..ops.kernels.bn_stats import bn_sums_cuda
    x = torch.randn(128, 32, 32, 64, device="cuda").to(torch.bfloat16)
    m0 = torch.zeros(64, device="cuda")

    def fn():
        bn_sums_cuda(x, m0)
        x[0, 0, 0, :8].add_(0)

    fn()
    torch.cuda.synchronize()
    rows = []
    for design, open_window in (("window", _window), ("warmup", _warmup)):
        totals, losing, gaps = collections.Counter(), [], []
        raised = 0
        for _ in range(SESSIONS):
            prof = open_window(fn)
            if design == "window":
                try:
                    profiling.window_kernels(prof)
                except profiling.LostRecords:
                    raised += 1
            got = session(prof)
            gaps += got.pop("gaps_us")
            totals.update({k: got.get(k, 0)
                           for k in ("kept", "head", "middle", "tail", "all")})
            if got["lost_ms"]:
                losing.append({k: got[k]
                               for k in ("lost_ms", "kept_ms_gap_us")})
        rows.append({"design": design, "sessions": SESSIONS,
                     "sessions_losing": len(losing), "launches": dict(totals),
                     "window_raised": raised if design == "window" else None,
                     "gap_us_min": min(gaps) if gaps else None,
                     "gap_us_median": statistics.median(gaps) if gaps else None,
                     "losing_sessions": losing[:10]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
