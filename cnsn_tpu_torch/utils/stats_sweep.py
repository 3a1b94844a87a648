"""The statistics kernels at the shapes of the main paths: each one's
plan and its time around the plan, beside the kernel it replaced, in the
same process.

    python -m cnsn_tpu_torch.utils.stats_sweep [--iters 20]
        [--only k1|k1bwd|k2|k2bwd|k3] [--baseline DIR]
        [--k1-constants NAME=VALUE,... ...]
        [--k2-constants NAME=VALUE,... ...]

K1 forward (``ins_stats``, one launch): one JSON line for each K1 call
shape of ResNet-50 (its 4 SelfNorm shapes at b=128 224² bf16 and the
image CrossNorm statistics, b=128 224²×3 fp32) and of WRN-40-2 (its 4
SelfNorm shapes at b=128 32² bf16): ``plan`` (``ins_stats_plan_of``),
``planned_ms``, ``ms_by_split`` over forced blocks per plane around the
plan, ``ms_by_lanes`` over forced lanes (8 to 256 that C fills, each
with its own split), ``variants_ms`` (each ``--k1-constants`` spec, say
``kUnroll=16,kFwdBlocksPerSm=2`` or ``Acc=double``: a copy of
``csrc/ins_stats.cu`` with those constants, timed at 1, 2 and 4 blocks
a plane), ``clean_ms`` (after an L2 flush that leaves clean lines,
``_time_clean_ms``), the bound, the error against the plain version and
the same bits run to run.

K1 backward (``ins_stats_bwd``, one streaming pass): one line for each
K1-backward shape of the main paths, b=128 bf16: ResNet-50's 4 SelfNorm
shapes and WRN-40-2's 4 (sn.yaml's pos 'pre'; cnsn.yaml's pos 'post' are
3 of them): ``plan`` (``ins_bwd_plan_of``), ``planned_ms``,
``ms_by_chunks`` over forced blocks per plane around the plan,
``clean_ms``, the bound, the error against the plain version and
``equal_to_plain`` (the same bits as it); ``variants_ms`` times the
backward of each ``--k1-constants`` copy (say ``kBwdUnroll=8`` or
``kBwdBlocksPerSm=3``) on the package's plan for a wave of the copy's
own residency.  A copy's compiler report (registers, spills) is kept
beside its library as ``lib.so.log``.

K2 backward (``bn_sums_bwd``, one streaming pass): one line for each of
ResNet-50's 12 BatchNorm2d input shapes and WRN-40-2's 4, b=128 bf16:
``plan`` (``bn_bwd_plan_of``), ``planned_ms``, ``ms_by_chunks`` over
forced chunk counts, ``clean_ms``, the bound and the error
(``--k2-constants kBwdStreamStores=1`` times dx stored evict-first).

With ``--baseline DIR`` (a directory holding an earlier
``cnsn_tpu_torch/csrc``, as in a ``git archive`` of that commit), DIR's
``ins_stats.cu`` and ``bn_stats.cu`` are built beside the package's and
their kernels timed at the same shapes as ``baseline_ms`` and
``baseline_clean_ms``: the first port's two-launch K1 forward
(``cnsn_ins_stats_chunks`` and ``cnsn_ins_stats``; its error against the
plain version as ``baseline_max_abs_err``), the first port's K1 backward
(``cnsn_ins_stats_bwd`` of n, hw and c; ``baseline_equal``: the same
bits as the new kernel, which the sweep requires), the first port's K2
backward
(``cnsn_bn_sums_bwd`` of rows and c; ``baseline_equal``: the same bits
as the new kernel, which the sweep requires), and DIR's K2 forward (the
two-launch ``cnsn_bn_sums_chunks`` or the one-launch
``cnsn_bn_sums_plan``, whichever DIR has).
A ``summary`` line per kernel sums each time by its launches
per step: the flagship's (16 SelfNorm sites, and the image statistics on
19 of its 35 gated steps) and WRN-40-2 sn.yaml's (K1 backward: cnsn.yaml's
too).

K2 forward (``bn_sums``): one line for each of ResNet-50's 12 BatchNorm2d
input shapes: ``plan`` (``bn_sums_plan``), ``planned_ms``, ``main_ms``
(the same launch stopped at its partials, no ticket and no final add;
``final_add_ms`` is the difference), ``ms_by_chunks`` over chunk counts
around the planned one (one less than the plan: the same rows per block
without clusters), ``clean_ms`` and the bound.  Each ``--k2-constants``
(say ``Sum=float,kFwdBlocksPerSm=5`` or ``kBwdUnroll=8``) builds a copy
of the package's ``csrc/bn_stats.cu`` with those ``constexpr int`` values
and sum type, its forward and backward timed per shape in
``variants_ms`` (the backward on the package's plan).

K3 (``selfnorm``): one line per SelfNorm shape of ResNet-50 at b=64 and
b=1 and of WRN-40-2 at b=128, in float32 and bfloat16: ``plan``
(``selfnorm_plan``), ``planned_ms``, ``ms_by_plan`` over every (lanes,
cluster) the kernel takes (key ``lanes x cluster``), ``v1_ms`` (the v1
kernel) and the bound.

Times: CUDA events around each launch, the 50 MB L2 overwritten and a
~1 ms spin on the card before each, as ``chip_smoke.py`` times them;
every timed configuration is first held to the plain version (K1: 1e-5
relative, chip_smoke's ``k1_vs_plain``; K1 backward: one bf16 ulp of
the largest |dx|, as chip_smoke; K2 forward: 1e-5 of Σ|x−m0| and of s2;
K2 backward: bit for bit; K3: chip_smoke's ``TOL``).  A first
line gives the method's floor: one launch of a one-element fill, timed
alike.  The last line names the card.  It needs a GPU and exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..models.resnet import block_plan
from ..ops.kernels._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from ..ops.kernels._launch import (DTYPE_CODE, FLOAT, INT, PTR,
                                  device_limits, vector_width)
from ..ops.kernels.bn_stats import _launch as _bn_launch
from ..ops.kernels.bn_stats import _launch_bwd as _bwd_launch
from ..ops.kernels.bn_stats import (bn_bwd_plan_of, bn_sums_bwd_cuda,
                                   bn_sums_bwd_reference, bn_sums_cuda,
                                   bn_sums_plan, bn_sums_reference)
from ..ops.kernels.ins_stats import _launch as _k1_launch
from ..ops.kernels.ins_stats import _launch_bwd as _k1_bwd_launch
from ..ops.kernels.ins_stats import (BWD_BLOCKS_PER_SM, MAX_CLUSTER,
                                    ins_bwd_plan, ins_bwd_plan_of,
                                    ins_stats_bwd_cuda,
                                    ins_stats_bwd_reference, ins_stats_cuda,
                                    ins_stats_plan_of, ins_stats_reference)
from ..ops.kernels.selfnorm import (PATHS, _launch, selfnorm_infer_reference,
                                    selfnorm_plan)
from .k4_sweep import SPIN_CYCLES, _time_ms

HBM_BYTES_PER_S = 3.35e12
# (H = W, C) of the SelfNorm sites: ResNet-50 at 224² (serving: b=64 and
# b=1), WRN-40-2 at 32² (eval: b=128)
SN_R50 = ((56, 256), (28, 512), (14, 1024), (7, 2048))
SN_WRN = ((32, 16), (32, 32), (16, 64), (8, 128))
# K1's launches per main-path step at each (H = W, C): the flagship's 16
# SelfNorm sites, WRN-40-2 sn.yaml's 18 (pos 'pre'); its BatchNorm2d
# inputs per step (K2)
K1_R50_SITES = {(56, 256): 3, (28, 512): 4, (14, 1024): 6, (7, 2048): 3}
K1_WRN_SITES = {(32, 16): 1, (32, 32): 6, (16, 64): 6, (8, 128): 5}
# and cnsn.yaml's 18 (pos 'post'), on every step
K1_WRN_POST_SITES = {(32, 32): 6, (16, 64): 6, (8, 128): 6}
K2_WRN_SITES = {(32, 16): 1, (32, 32): 12, (16, 64): 12, (8, 128): 12}
# the image statistics run on a cn_image step: 19 of the flagship's 35
# gated steps (RandomState(7).rand(35) < 0.5)
IMAGE_PER_STEP = 19 / 35
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


def bn_shapes(image: int = 224) -> collections.Counter:
    """{(H = W, C): layers} of ResNet-50's BatchNorm2d inputs."""
    shapes = collections.Counter({(image // 2, 64): 1})
    hw = image // 4
    for blk in block_plan((3, 4, 6, 3)):
        out_hw = hw // blk["stride"]
        shapes[(hw, blk["planes"])] += 1
        shapes[(out_hw, blk["planes"])] += 1
        shapes[(out_hw, 4 * blk["planes"])] += 1 + blk["has_downsample"]
        hw = out_hw
    return shapes


def _build_from(src: Path, name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` of the checkout at ``src``, built beside the
    package's libraries."""
    out = BUILD_DIR / "baseline" / f"lib{name}_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                    str(src / "cnsn_tpu_torch" / "csrc" / f"{name}.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _bind(lib, name, *argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError {err}")


def _baseline_bn_sums(lib):
    """DIR's K2 forward: a callable (x, m0) -> (s1, s2), through the
    two-launch interface (``cnsn_bn_sums_chunks``) or the one-launch plan
    (``cnsn_bn_sums_plan``)."""
    if hasattr(lib, "cnsn_bn_sums_chunks"):
        chunks_of = _bind(lib, "cnsn_bn_sums_chunks", INT, INT, INT)
        fwd = _bind(lib, "cnsn_bn_sums", INT, INT, PTR, PTR, PTR, PTR, PTR,
                    INT, INT, INT, PTR)

        def run(x, m0):
            c = x.shape[-1]
            rows, vec = x.numel() // c, vector_width(x)
            chunks = chunks_of(rows, c, vec)
            part = torch.empty((2, chunks, c), device=x.device)
            s1 = torch.empty(c, device=x.device)
            s2 = torch.empty(c, device=x.device)
            _check(fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(),
                       m0.data_ptr(), part.data_ptr(), s1.data_ptr(),
                       s2.data_ptr(), rows, c, chunks, _stream()),
                   "baseline bn_sums")
            return s1, s2
        return run
    return _bn_plan_runner(lib, torch.float64, "baseline bn_sums")


def _baseline(src: Path):
    """The K2 forward of the checkout at ``src``, built beside the
    package's: a callable (x, m0) -> (s1, s2) (``train/rounding.py
    --baseline`` trains with it)."""
    return _baseline_bn_sums(_build_from(src, "bn_stats"))


def _bn_plan_runner(lib, sums, what: str):
    """A callable (x, m0) -> (s1, s2) through a library's one-launch K2
    forward (``cnsn_bn_sums_plan``, ``cnsn_bn_sums``)."""
    plan_of = _bind(lib, "cnsn_bn_sums_plan", *[INT] * 5,
                    ctypes.POINTER(ctypes.c_int))
    fwd = _bind(lib, "cnsn_bn_sums", INT, INT, PTR, PTR, PTR, PTR, INT, PTR,
                PTR, INT, INT, INT, INT, INT, PTR)
    tickets = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def run(x, m0):
        c = x.shape[-1]
        rows, vec, plan = x.numel() // c, vector_width(x), (ctypes.c_int * 5)()
        _check(plan_of(DTYPE_CODE[x.dtype], vec, rows, c, 0, plan),
               f"{what}: no plan")
        part = torch.empty((2, plan[0] // plan[4], c), dtype=sums,
                           device=x.device)
        s1 = torch.empty(c, device=x.device)
        s2 = torch.empty(c, device=x.device)
        _check(fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(), m0.data_ptr(),
                   part.data_ptr(), tickets.data_ptr(), tickets.numel(),
                   s1.data_ptr(), s2.data_ptr(), rows, c, plan[0], plan[4], 1,
                   _stream()), what)
        return s1, s2
    return run


def _baseline_ins_stats(lib):
    """The first port's two-launch K1 forward: a callable (x, eps) ->
    (mean, std)."""
    chunks_of = _bind(lib, "cnsn_ins_stats_chunks", INT, INT, INT, INT)
    fwd = _bind(lib, "cnsn_ins_stats", INT, INT, PTR, PTR, PTR, PTR, INT, INT,
                INT, INT, FLOAT, INT, PTR)

    def run(x, eps):
        n, h, w, c = x.shape
        vec = vector_width(x)
        chunks = chunks_of(n, h * w, c, vec)
        part = torch.empty((2, n, chunks, c), device=x.device)
        mean = torch.empty((n, c), device=x.device)
        std = torch.empty_like(mean)
        _check(fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(), part.data_ptr(),
                   mean.data_ptr(), std.data_ptr(), n, h * w, c, chunks, eps,
                   1, _stream()), "baseline ins_stats")
        return mean, std
    return run


def _baseline_ins_bwd(lib):
    """The first port's K1 backward: a callable (x, mean, std, gm, gs) ->
    dx (ddof 1)."""
    bwd = _bind(lib, "cnsn_ins_stats_bwd", INT, INT, PTR, PTR, PTR, PTR, PTR,
                PTR, INT, INT, INT, INT, PTR)

    def run(x, mean, std, gm, gs):
        n, h, w, c = x.shape
        dx = torch.empty_like(x)
        _check(bwd(DTYPE_CODE[x.dtype], vector_width(x), x.data_ptr(),
                   mean.data_ptr(), std.data_ptr(), gm.data_ptr(),
                   gs.data_ptr(), dx.data_ptr(), n, h * w, c, 1, _stream()),
               "baseline ins_stats_bwd")
        return dx
    return run


def _baseline_bn_bwd(lib):
    """The first port's K2 backward: a callable (x, m0, g1, g2) -> dx."""
    bwd = _bind(lib, "cnsn_bn_sums_bwd", INT, INT, PTR, PTR, PTR, PTR, PTR,
                INT, INT, PTR)

    def run(x, m0, g1, g2):
        c = x.shape[-1]
        dx = torch.empty_like(x)
        _check(bwd(DTYPE_CODE[x.dtype], vector_width(x), x.data_ptr(),
                   m0.data_ptr(), g1.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                   x.numel() // c, c, _stream()), "baseline bn_sums_bwd")
        return dx
    return run


def _variant(spec: str, name: str = "bn_stats"):
    """``csrc/<name>.cu`` built with the constants of ``spec``
    ("NAME=VALUE,...": its ``constexpr int``s, and the sum types ``Sum``
    and, in ins_stats.cu, ``Acc`` = double or float) beside the package's
    libraries.  For bn_stats: callables (x,
    m0) -> (s1, s2) and (x, m0, g1, g2) -> dx; for ins_stats: callables
    (x, split) -> (mean, std) on the package's plan for that split and
    (x, mean, std, gm, gs) -> dx on the package's backward plan."""
    text = (CSRC_DIR / f"{name}.cu").read_text()
    sums = torch.float64
    for item in spec.split(","):
        key, value = item.split("=")
        if key in ("Sum", "Acc"):
            if key == "Sum":
                sums = {"double": torch.float64,
                        "float": torch.float32}[value]
            text, n = re.subn(rf"using {key} = \w+;",
                              f"using {key} = {value};", text)
        else:
            text, n = re.subn(rf"constexpr int {key} = \d+;",
                              f"constexpr int {key} = {int(value)};", text)
        if n != 1:
            raise ValueError(f"constants: no {key} in {name}.cu")
    out = BUILD_DIR / "variants" / name / re.sub(r"\W", "_", spec)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    (out / "row_pass.cuh").write_bytes((CSRC_DIR / "row_pass.cuh")
                                       .read_bytes())
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out / "lib.so"),
                           str(out / f"{name}.cu")], check=True,
                          capture_output=True, text=True)
    (out / "lib.so.log").write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out / "lib.so"))
    if name == "ins_stats":
        return _k1_runner(lib, spec), _k1_bwd_runner(lib, spec)
    return _bn_plan_runner(lib, sums, spec), _bn_bwd_runner(lib, spec)


def _k1_runner(lib, what: str):
    """A callable (x, split) -> (mean, std) through a library's one-launch
    K1 forward (``cnsn_ins_stats``), on the package's plan for ``split``
    blocks a plane."""
    fwd = _bind(lib, "cnsn_ins_stats", INT, INT, PTR, PTR, PTR, INT, INT,
                INT, INT, INT, INT, FLOAT, INT, PTR)

    def run(x, split):
        n, h, w, c = x.shape
        plan = ins_stats_plan_of(x, split)
        mean = torch.empty((n, c), device=x.device)
        std = torch.empty_like(mean)
        _check(fwd(DTYPE_CODE[x.dtype], vector_width(x), x.data_ptr(),
                   mean.data_ptr(), std.data_ptr(), n, h * w, c,
                   plan["lanes"], plan["split"], plan["chunk_rows"], 1e-5, 1,
                   _stream()), what)
        return mean, std
    return run


def _k1_bwd_runner(lib, what: str):
    """A callable (x, mean, std, gm, gs) -> dx through a library's
    streaming K1 backward (``cnsn_ins_stats_bwd`` of a plan), on the
    package's plan for a wave of the library's own residency (ddof 1)."""
    bwd = _bind(lib, "cnsn_ins_stats_bwd", INT, INT, PTR, PTR, PTR, PTR, PTR,
                PTR, INT, INT, INT, INT, INT, INT, INT, PTR)
    occupancy = _bind(lib, "cnsn_ins_stats_bwd_occupancy", INT, INT,
                      ctypes.POINTER(ctypes.c_int))

    def run(x, mean, std, gm, gs):
        n, h, w, c = x.shape
        vec, occ = vector_width(x), ctypes.c_int()
        _check(occupancy(DTYPE_CODE[x.dtype], vec, ctypes.byref(occ)),
               f"{what}: occupancy")
        # the SM count whose wave at the package's residency is the
        # library's wave on this card
        sms = device_limits(x.device)[0] * occ.value // BWD_BLOCKS_PER_SM
        plan = ins_bwd_plan(n, h * w, c, x.dtype, vec, sms)
        dx = torch.empty_like(x)
        _check(bwd(DTYPE_CODE[x.dtype], vector_width(x), x.data_ptr(),
                   mean.data_ptr(), std.data_ptr(), gm.data_ptr(),
                   gs.data_ptr(), dx.data_ptr(), n, h * w, c, 1,
                   plan["lanes"], plan["chunks"], plan["chunk_rows"],
                   _stream()), what)
        return dx
    return run


def _bn_bwd_runner(lib, what: str):
    """A callable (x, m0, g1, g2) -> dx through a library's streaming K2
    backward (``cnsn_bn_sums_bwd`` of a plan), on the package's plan."""
    bwd = _bind(lib, "cnsn_bn_sums_bwd", INT, INT, PTR, PTR, PTR, PTR, PTR,
                INT, INT, INT, INT, INT, PTR)

    def run(x, m0, g1, g2):
        c = x.shape[-1]
        plan = bn_bwd_plan_of(x)
        dx = torch.empty_like(x)
        _check(bwd(DTYPE_CODE[x.dtype], vector_width(x), x.data_ptr(),
                   m0.data_ptr(), g1.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                   x.numel() // c, c, plan["lanes"], plan["chunks"],
                   plan["chunk_rows"], _stream()),
               what)
        return dx
    return run


def _bn_check(got, want, x, m0, what: str) -> float:
    torch.cuda.synchronize()
    d_abs = (x.float() - m0).abs().sum(dim=(0, 1, 2))
    (s1, s2), (w1, w2) = got, want
    if not (bool(((s1 - w1).abs() <= 1e-5 * d_abs).all())
            and bool(((s2 - w2).abs() <= 1e-5 * w2).all())):
        raise RuntimeError(f"{what} disagrees with plain")
    return max((s1 - w1).abs().max().item(), (s2 - w2).abs().max().item())


def sweep_k2(hw: int, c: int, layers: int, iters: int, flush, baseline,
             variants: dict):
    gen = torch.Generator(device="cuda").manual_seed(hw * 10_000 + c)
    x = (torch.randn(128, hw, hw, c, generator=gen, device="cuda") * 1.5
         + 0.5).bfloat16()
    m0 = torch.randn(c, generator=gen, device="cuda") * 0.3
    want = bn_sums_reference(x, m0)
    plan = bn_sums_plan(x)
    pick = plan["chunks"]
    err = _bn_check(bn_sums_cuda(x, m0), want, x, m0, "bn_sums")
    row = {"kernel": "bn_sums", "shape": [128, hw, hw, c],
           "dtype": "bfloat16", "sites": layers, "plan": plan,
           "max_abs_err": err,
           "planned_ms": _time_ms(lambda: bn_sums_cuda(x, m0), iters, flush),
           "main_ms": _time_ms(lambda: _bn_launch(x, m0, finish=False),
                               iters, flush),
           "bound_ms": (x.numel() * 2 + 3 * c * 4) / HBM_BYTES_PER_S * 1e3}
    row["final_add_ms"] = row["planned_ms"] - row["main_ms"]
    # pick - 1: the same rows per block without clusters
    counts = sorted({max(1, pick // 4), max(1, pick // 2), max(1, pick - 1),
                     2 * pick, 4 * pick} - {pick})
    ms = {}
    for k in counts:
        _bn_check(_bn_launch(x, m0, chunks=k), want, x, m0,
                  f"bn_sums at {k} chunks")
        ms[k] = _time_ms(lambda k=k: _bn_launch(x, m0, chunks=k), iters,
                         flush)
    row["ms_by_chunks"] = ms
    if baseline is not None:
        _bn_check(baseline(x, m0), want, x, m0, "baseline bn_sums")
        row["baseline_ms"] = _time_ms(lambda: baseline(x, m0), iters, flush)
        row["baseline_clean_ms"] = _time_clean_ms(lambda: baseline(x, m0),
                                                  iters, flush)
    row["clean_ms"] = _time_clean_ms(lambda: bn_sums_cuda(x, m0), iters,
                                     flush)
    row["variants_ms"] = {}
    for spec, (fn, _) in variants.items():
        _bn_check(fn(x, m0), want, x, m0, spec)
        row["variants_ms"][spec] = _time_ms(lambda fn=fn: fn(x, m0), iters,
                                            flush)
    return row


def sweep_k1(hw: int, c: int, dtype, sites: dict, iters: int, flush,
             baseline, variants: dict):
    """K1's forward at (128, hw, hw, c): one line (module docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(hw * 10_000 + c + 1)
    x = (torch.randn(128, hw, hw, c, generator=gen, device="cuda") * 1.5
         + 0.3).to(dtype)
    want = ins_stats_reference(x)

    def held(got, what):
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{what}: {m}")
        return max((g - r).abs().max().item() for g, r in zip(got, want))

    plan = ins_stats_plan_of(x)
    got = ins_stats_cuda(x)
    again = ins_stats_cuda(x)
    err = held(got, "ins_stats")
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise RuntimeError(f"ins_stats {x.shape}: other bits run to run")
    row = {"kernel": "ins_stats", "shape": list(x.shape),
           "dtype": str(dtype).split(".")[1], "sites": sites, "plan": plan,
           "max_abs_err": err,
           "planned_ms": _time_ms(lambda: ins_stats_cuda(x), iters, flush),
           "clean_ms": _time_clean_ms(lambda: ins_stats_cuda(x), iters,
                                      flush),
           "bound_ms": (x.numel() * x.element_size() + 2 * 128 * c * 4)
           / HBM_BYTES_PER_S * 1e3}
    ms = {}
    for k in sorted({1, 2, 4, MAX_CLUSTER} - {plan["split"]}):
        held(_k1_launch(x, split=k), f"ins_stats split {k}")
        ms[k] = _time_ms(lambda k=k: _k1_launch(x, split=k), iters, flush)
    row["ms_by_split"] = ms
    ms = {}
    for lanes in (8, 16, 32, 64, 128, 256):
        if lanes != plan["lanes"] and lanes < 2 * -(-c // vector_width(x)):
            held(_k1_launch(x, lanes=lanes), f"ins_stats lanes {lanes}")
            ms[lanes] = _time_ms(lambda k=lanes: _k1_launch(x, lanes=k),
                                 iters, flush)
    row["ms_by_lanes"] = ms
    row["variants_ms"] = {}
    for spec, (fn, _) in variants.items():
        row["variants_ms"][spec] = {}
        for k in (1, 2, 4):
            held(fn(x, k), f"{spec} split {k}")
            row["variants_ms"][spec][k] = _time_ms(lambda k=k: fn(x, k),
                                                   iters, flush)
    if baseline is not None:
        row["baseline_max_abs_err"] = held(baseline(x, 1e-5),
                                           "baseline ins_stats")
        row["baseline_ms"] = _time_ms(lambda: baseline(x, 1e-5), iters,
                                      flush)
        row["baseline_clean_ms"] = _time_clean_ms(lambda: baseline(x, 1e-5),
                                                  iters, flush)
    return row


def sweep_k1bwd(hw: int, c: int, sites: dict, iters: int, flush, baseline,
                variants: dict):
    """K1's backward at (128, hw, hw, c) bf16: one line (module
    docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(hw * 10_000 + c + 3)
    x = (torch.randn(128, hw, hw, c, generator=gen, device="cuda") * 1.5
         + 0.3).bfloat16()
    mean, std = ins_stats_reference(x)
    gm = torch.randn(128, c, generator=gen, device="cuda")
    gs = torch.randn(128, c, generator=gen, device="cuda")
    want = ins_stats_bwd_reference(x, mean, std, gm, gs)
    scale = want.float().abs().max().item()
    args = (x, mean, std, gm, gs)

    def held(got, what):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= 2 ** -7 * scale:
            raise RuntimeError(f"{what} {x.shape}: {err} from plain")
        return got, err

    plan = ins_bwd_plan_of(x)
    got, err = held(ins_stats_bwd_cuda(*args), "ins_stats_bwd")
    row = {"kernel": "ins_stats_bwd", "shape": list(x.shape),
           "dtype": "bfloat16", "sites": sites, "plan": plan,
           "max_abs_err": err, "equal_to_plain": torch.equal(got, want),
           "planned_ms": _time_ms(lambda: ins_stats_bwd_cuda(*args), iters,
                                  flush),
           "clean_ms": _time_clean_ms(lambda: ins_stats_bwd_cuda(*args),
                                      iters, flush),
           "bound_ms": (2 * x.numel() * 2 + 4 * 128 * c * 4)
           / HBM_BYTES_PER_S * 1e3}
    pick = plan["chunks"]
    ms = {}
    for k in (max(1, pick // 4), max(1, pick // 2), 2 * pick, 4 * pick,
              8 * pick):
        k = ins_bwd_plan_of(x, k)["chunks"]
        if k != pick and k not in ms:
            if not torch.equal(held(_k1_bwd_launch(*args, chunks=k),
                                    f"ins_stats_bwd {k} chunks")[0], got):
                raise RuntimeError(f"ins_stats_bwd {x.shape}: other bits "
                                   f"at {k} chunks")
            ms[k] = _time_ms(lambda k=k: _k1_bwd_launch(*args, chunks=k),
                             iters, flush)
    row["ms_by_chunks"] = ms
    row["variants_ms"] = {}
    for spec, (_, fn) in variants.items():
        held(fn(*args), spec)
        row["variants_ms"][spec] = _time_ms(lambda fn=fn: fn(*args), iters,
                                            flush)
    if baseline is not None:
        row["baseline_equal"] = torch.equal(baseline(*args), got)
        if not row["baseline_equal"]:
            raise RuntimeError(f"baseline ins_stats_bwd {x.shape}: other "
                               "bits")
        row["baseline_ms"] = _time_ms(lambda: baseline(*args), iters, flush)
        row["baseline_clean_ms"] = _time_clean_ms(lambda: baseline(*args),
                                                  iters, flush)
    return row


def sweep_k2bwd(hw: int, c: int, sites: dict, iters: int, flush, baseline,
                variants: dict):
    """K2's backward at (128, hw, hw, c) bf16: one line (module
    docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(hw * 10_000 + c + 2)
    x = (torch.randn(128, hw, hw, c, generator=gen, device="cuda") * 1.5
         + 0.5).bfloat16()
    m0 = torch.randn(c, generator=gen, device="cuda") * 0.3
    g1 = torch.randn(c, generator=gen, device="cuda")
    g2 = torch.randn(c, generator=gen, device="cuda") * 1e-3
    want = bn_sums_bwd_reference(x, m0, g1, g2)

    def held(got, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{what} {x.shape}: other bits than plain")

    plan = bn_bwd_plan_of(x)
    held(bn_sums_bwd_cuda(x, m0, g1, g2), "bn_sums_bwd")
    row = {"kernel": "bn_sums_bwd", "shape": list(x.shape),
           "dtype": "bfloat16", "sites": sites, "plan": plan,
           "max_abs_err": 0.0,
           "planned_ms": _time_ms(lambda: bn_sums_bwd_cuda(x, m0, g1, g2),
                                  iters, flush),
           "clean_ms": _time_clean_ms(
               lambda: bn_sums_bwd_cuda(x, m0, g1, g2), iters, flush),
           "bound_ms": (2 * x.numel() * 2 + 3 * c * 4) / HBM_BYTES_PER_S
           * 1e3}
    pick = plan["chunks"]
    ms = {}
    for k in sorted({max(1, pick // 4), max(1, pick // 2), 2 * pick,
                     4 * pick} - {pick}):
        held(_bwd_launch(x, m0, g1, g2, chunks=k), f"bn_sums_bwd {k} chunks")
        ms[k] = _time_ms(lambda k=k: _bwd_launch(x, m0, g1, g2, chunks=k),
                         iters, flush)
    row["ms_by_chunks"] = ms
    row["variants_ms"] = {}
    for spec, (_, fn) in variants.items():
        held(fn(x, m0, g1, g2), spec)
        row["variants_ms"][spec] = _time_ms(lambda fn=fn: fn(x, m0, g1, g2),
                                            iters, flush)
    if baseline is not None:
        row["baseline_equal"] = torch.equal(baseline(x, m0, g1, g2), want)
        if not row["baseline_equal"]:
            raise RuntimeError(f"baseline bn_sums_bwd {x.shape}: other bits")
        row["baseline_ms"] = _time_ms(lambda: baseline(x, m0, g1, g2), iters,
                                      flush)
        row["baseline_clean_ms"] = _time_clean_ms(
            lambda: baseline(x, m0, g1, g2), iters, flush)
    return row


def _summary(rows, kernel: str) -> dict:
    """Each time key of ``rows`` summed by the rows' launches per step of
    each path."""
    out = {"summary": kernel}
    paths = sorted({path for r in rows for path in r["sites"]})
    for path in paths:
        part = [r for r in rows if path in r["sites"]]
        keys = [k for k in ("planned_ms", "clean_ms", "bound_ms",
                            "baseline_ms", "baseline_clean_ms")
                if all(k in r for r in part)]
        out[path] = {k: sum(r[k] * r["sites"][path] for r in part)
                     for k in keys}
    return out


def _time_clean_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """As ``_time_ms``, but the L2 is overwritten by a read of ``flush``, so
    the lines it leaves are clean: the launch pays no write-back of lines
    dirtied before it."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def sweep_k3(n: int, side: int, c: int, dtype, iters: int, flush):
    gen = torch.Generator(device="cuda").manual_seed(n * 1000 + c)
    x = (torch.randn(n, side, side, c, generator=gen, device="cuda") * 1.5
         + 0.3).to(dtype)
    w = torch.randn(c, 2, generator=gen, device="cuda") * 0.3
    a = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    want = selfnorm_infer_reference(x, w, a, b).float()
    item = x.element_size()
    plan = selfnorm_plan(x)

    def timed(path, lanes=0, cluster=0):
        def run():
            return _launch(x, w, a, b, 1e-12, path, lanes, cluster)
        got = run()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL[dtype])
        return _time_ms(run, iters, flush)

    # every (lanes, cluster) the kernel takes for x; it refuses the others
    ms = {}
    for lanes in (1, 2, 4, 8, 16, 32):
        for cluster in (1, 2, 4, 8):
            try:
                ms[f"{lanes}x{cluster}"] = timed("staged", lanes, cluster)
            except RuntimeError as err:
                if "cudaError" not in str(err):
                    raise
    planned = f"{plan['lanes']}x{plan['cluster']}"
    return {"kernel": PATHS["staged"][1], "shape": [n, side, side, c],
            "dtype": str(dtype).split(".")[1], "plan": plan,
            "planned_ms": ms[planned], "best_plan": min(ms, key=ms.get),
            "ms_by_plan": ms, "v1_ms": timed("v1"),
            "bound_ms": 2 * x.numel() * item / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("k1", "k1bwd", "k2", "k2bwd", "k3"))
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--k1-constants", action="append", default=[])
    ap.add_argument("--k2-constants", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stats_sweep: needs a GPU", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def wanted(name):
        return args.only in (None, name)

    def base(build, name):
        return build(_build_from(args.baseline, name)) if args.baseline \
            else None

    # the measurement's floor: one launch of a one-element fill, timed
    # as every kernel here is timed
    one = torch.empty(1, device="cuda")
    print(json.dumps({"floor_ms": _time_ms(lambda: one.fill_(0), args.iters,
                                           flush),
                      "floor_clean_ms": _time_clean_ms(
                          lambda: one.fill_(0), args.iters, flush),
                      "what": "one-element torch fill_, one launch"}),
          flush=True)
    variants = {spec: _variant(spec) for spec in args.k2_constants}
    k1_variants = {spec: _variant(spec, "ins_stats")
                   for spec in args.k1_constants}
    if wanted("k1"):
        baseline = base(_baseline_ins_stats, "ins_stats")
        cases = [(s, c, torch.bfloat16, {"flagship": k})
                 for (s, c), k in K1_R50_SITES.items()]
        cases.append((224, 3, torch.float32, {"flagship": IMAGE_PER_STEP}))
        cases += [(s, c, torch.bfloat16, {"wrn_sn": k})
                  for (s, c), k in K1_WRN_SITES.items()]
        rows = []
        for hw, c, dtype, sites in cases:
            rows.append(sweep_k1(hw, c, dtype, sites, args.iters, flush,
                                 baseline, k1_variants))
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps(_summary(rows, "ins_stats")), flush=True)
    if wanted("k1bwd"):
        baseline = base(_baseline_ins_bwd, "ins_stats")
        cases = [(s, c, {"flagship": k}) for (s, c), k in K1_R50_SITES.items()]
        cases += [(s, c, {"wrn_sn": k, **({"wrn_cnsn": K1_WRN_POST_SITES[s, c]}
                                          if (s, c) in K1_WRN_POST_SITES
                                          else {})})
                  for (s, c), k in K1_WRN_SITES.items()]
        rows = []
        for hw, c, sites in cases:
            rows.append(sweep_k1bwd(hw, c, sites, args.iters, flush,
                                    baseline, k1_variants))
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps(_summary(rows, "ins_stats_bwd")), flush=True)
    if wanted("k2bwd"):
        baseline = base(_baseline_bn_bwd, "bn_stats")
        cases = [(s, c, {"flagship": k}) for (s, c), k in
                 sorted(bn_shapes().items(), key=lambda kv: -kv[0][0])]
        cases += [(s, c, {"wrn_sn": k}) for (s, c), k in K2_WRN_SITES.items()]
        rows = []
        for hw, c, sites in cases:
            rows.append(sweep_k2bwd(hw, c, sites, args.iters, flush,
                                    baseline, variants))
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps(_summary(rows, "bn_sums_bwd")), flush=True)
    if wanted("k2"):
        baseline = _baseline(args.baseline) if args.baseline else None
        for (hw, c), layers in sorted(bn_shapes().items(),
                                      key=lambda kv: (-kv[0][0], kv[0][1])):
            print(json.dumps(sweep_k2(hw, c, layers, args.iters, flush,
                                      baseline, variants)), flush=True)
    if wanted("k3"):
        cases = [(n, s, c) for n in (64, 1) for s, c in SN_R50]
        cases += [(128, s, c) for s, c in SN_WRN]
        for dtype in (torch.bfloat16, torch.float32):
            for n, side, c in cases:
                print(json.dumps(sweep_k3(n, side, c, dtype, args.iters,
                                          flush)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
