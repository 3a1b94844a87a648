#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``cnsn_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels (K1 instance statistics, K2 BatchNorm
sums, K3 eval SelfNorm, K4 3×3 conv weight gradient) from the sources in
the checkout, all at once, and holds each kernel, forward and backward,
against its plain PyTorch version at the shapes ResNet-50 and WRN-40-2
give it, with times beside its bound and the library's call (K3 at
ResNet-50's shapes at b=64 and b=1 and WRN-40-2's at b=128, its staged
kernel with the first, v1 kernel beside it).  Then it drives the port's
main paths with the launch counts read around each (and, in the profiled
training steps, one kernel per K1 and K2 launch each way: K2 once per
BatchNorm2d layer, K1 once per SelfNorm site and image statistics):

  * training, the flagship recipe (``cnsn_tpu/configs/imagenet/resnet50/
    cnsn.yaml``: SelfNorm at pos='post', image CrossNorm gated per batch
    at cn_prob 0.5), full-width ResNet-50 at b=128 224² bf16 for 35 SGD
    steps, timed as ``bench.py`` times its JAX twin, profiled, and then
    evaluated through K3 (after a reduced-depth model's three steps on the
    card and on the CPU are each held against a float64 twin); then 5
    steps of it with CNSN_CONV3X3=pallas (13 K4 launches per step, all
    through K4's wgmma kernel);
  * training, the CIFAR SelfNorm recipe (``cnsn_tpu/configs/cifar10/
    wideresnet/sn.yaml``: WRN-40-2, SelfNorm at pos='pre'), b=128 32² bf16
    for 35 steps with CNSN_CONV3X3=pallas (35 K4 launches per step: 22
    through the wgmma kernel, 13 through the narrow kernel) and
    again with cuDNN's gradients, profiled, then evaluated through K3;
    before it, one float32 step of a reduced WRN under both, from the
    same weights, every conv weight's gradient compared;
  * training with in-network CrossNorm, the CIFAR ``cn`` regime
    (``cnsn_tpu/configs/cifar10/wideresnet/cn.yaml``: CrossNorm sites at
    pos='post', crop 'neither'; ``cnsn.yaml``: CNSN sites, crop 'both'; 2
    of 18 sites on per cn step), WRN-40-2 at b=128 32² bf16 under
    CNSN_CONV3X3=pallas, 35 gated steps of each timed and profiled, the
    launches checked step by step, then an eval step of the cnsn.yaml
    model through K3; before it, one cn step of a reduced WRN with fixed
    draws for three knob sets (CrossNorm 'neither', CNSN 'both', the fused
    CNSN 'style'), on the card and on the CPU, each held against a
    float64 twin; after it, 5 steps of ``imagenet/resnet50/cn.yaml``
    (image CrossNorm, crop 'both', on a plain ResNet-50);
  * the host side of CIFAR training on cnsn.yaml (phase ``trainer_wrn``):
    ``cli train`` for two epochs on the synthetic set, ``cli eval
    resume=`` reproducing the last epoch's Test Error and ``cli export
    resume=`` against the checkpoint's eager forward; then a ``Trainer``
    epoch of 40 steps and an evaluation of 10,000 images at batch 1000
    (K3 at N = 1000) timed, their launches checked, beside the loader's
    own time, the wait for staged batches and a profile of trainer steps;
  * serving (build_classifier → export_classifier → save_artifact →
    load_artifact → requests at b=1 and b=64), timed and profiled, after
    the full-width eval forward is held against the CPU's.

Weights and data are random, drawn from seeds.  Every phase prints one
JSON line; any failure raises and exits non-zero.  The last lines are
the kernel summary, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or where the
``cnsn_tpu_torch`` package is not beside it.
"""
import collections
import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate, bf16
# tensor-core rate, fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
BATCH = 64
IMAGE = 224
# (H = W, C, sites) of the 16 SelfNorm sites of ResNet-50 at 224², pos='post'
SN_SHAPES = ((56, 256, 3), (28, 512, 4), (14, 1024, 6), (7, 2048, 3))
# WRN-40-2 at 32², pos='pre': (H = W, C, sites) of its 18 SelfNorm sites
# (each group's first block normalises the group's input), and of its 37
# BatchNorm2d inputs (each block's two, and the last after group 3)
WRN_SN_SHAPES = ((32, 16, 1), (32, 32, 6), (16, 64, 6), (8, 128, 5))
WRN_BN_SHAPES = ((32, 16, 1), (32, 32, 12), (16, 64, 12), (8, 128, 12))
# WRN-40-2 at pos 'post': (H = W, C, sites) of each group's block outputs,
# where cn.yaml's CrossNorm and cnsn.yaml's CrossNorm and SelfNorm sit
WRN_POST_SHAPES = ((32, 32, 6), (16, 64, 6), (8, 128, 6))
# K1's calls on the three WRN-40-2 recipes at b=128 bf16: (recipe, shapes,
# eps): SelfNorm's statistics (eps 1e-12) at sn.yaml's 18 pos-'pre' sites
# and cnsn.yaml's 18 pos-'post' sites on every step, CrossNorm's (eps
# 1e-5) at cn.yaml's active sites (2 of 18 per cn step)
WRN_K1_CASES = (("sn.yaml", WRN_SN_SHAPES, 1e-12),
                ("cnsn.yaml", WRN_POST_SHAPES, 1e-12),
                ("cn.yaml", WRN_POST_SHAPES, 1e-5))
RECIPE = os.path.join(ROOT, "cnsn_tpu", "configs", "imagenet", "resnet50",
                      "cnsn.yaml")
# bench.py's loop: 5 warm-up steps, then 3 timed windows of 10, gated by
# np.random.RandomState(7).rand(35) < cn_prob
WARMUP, WINDOWS, WINDOW, GATE_SEED = 5, 3, 10, 7
TRAIN_STEPS = WARMUP + WINDOWS * WINDOW
# ImageNet-1k's 1,281,167 training images at b=128: the epoch of the step LR
STEPS_PER_EPOCH = 10_009
# ResNet-50: 53 BatchNorm2d layers, 16 SelfNorm sites
BN_LAYERS, SN_SITES = 53, 16
WRN_RECIPE = os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10",
                          "wideresnet", "sn.yaml")
WRN_IMAGE = 32
# CIFAR-10's 50,000 training images at b=128, last partial batch dropped
# (cnsn_tpu/data/cifar.py:126-135): the epoch of the cosine LR
WRN_STEPS_PER_EPOCH = 390
# WRN-40-2, SelfNorm pos='pre': 37 BatchNorm2d layers, 18 SelfNorm sites,
# 35 stride-1 3x3 convs (all but the two stride-2 transitions)
WRN_BN, WRN_SN, WRN_K4 = 37, 18, 35
# (H = W, Cin, Cout, sites per step) of every stride-1 3x3 conv at b=128:
# WRN-40-2 at 32² and ResNet-50 v1.5 at 224²
K4_WRN = ((32, 3, 16, 1), (32, 16, 32, 1), (32, 32, 32, 11),
          (16, 64, 64, 11), (8, 128, 128, 11))
K4_R50 = ((56, 64, 64, 3), (28, 128, 128, 3), (14, 256, 256, 5),
          (7, 512, 512, 2))
R50_K4 = sum(r[3] for r in K4_R50)  # 13
# K4's three kernels (ops/kernels/conv_wgrad.py::wgrad3x3_path): wgmma for
# bf16 with Cin, Cout multiples of 64 (every ResNet-50 site; WRN's 16² 64→64
# and 8² 128→128, 11 sites each), narrow for bf16 with Cin, Cout ≤ 32 (WRN's
# 13 narrow sites: 3→16, 16→32, 11 × 32→32), wmma for the rest (fp32,
# unaligned views; no site of either bf16 training path)
WRN_K4_WGMMA, WRN_K4_NARROW = 22, 13
K4_WMMA, K4_WGMMA, K4_NARROW = ("conv_wgrad3x3", "conv_wgrad3x3_wgmma",
                                "conv_wgrad3x3_narrow")
K4_KERNELS = (K4_WMMA, K4_WGMMA, K4_NARROW)
# K3's two kernels (ops/kernels/selfnorm.py::selfnorm_path): staged for
# every SelfNorm site of both models (bf16 and fp32, C a multiple of the
# 16-byte vector, aligned), v1 (the first port's kernel) for the rest
K3_STAGED, K3_V1 = "selfnorm_infer_staged", "selfnorm_infer"
FLAGSHIP_K4_STEPS = 5
# K4 against its plain version: 1e-5 of Σ|x|·|dy| per element.  Both sum
# exact (bf16) or singly rounded (fp32) products in fp32 in other orders;
# such sums round near 1e-7 of that scale, where a misplaced tap or
# channel is off by the whole gradient.
K4_TOL = 1e-5
# one bf16 ulp is at most 2^-7 of the value; fp32 sums in another order
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}
# Card vs CPU logits, fp32 with TF32 off: 53 convs whose algorithms sum
# in other orders on each side, relative to the logits' scale.
LOGIT_TOL = 1e-3
ARTIFACT_TOL = 1e-3
# A float32 training run against its mask-replaying float64 twin: two
# float32 implementations round differently, and the three steps amplify
# it, so the card's error is held to a multiple of the CPU's.  Set from a
# reading before the bound existed (card/CPU ratios 0.7-3.2 over the
# losses and the step-1 and step-3 tensors); the floor, ~16 float32 ulps,
# keeps a loss that the CPU rounds luckily from setting the bound.
CARD_VS_CPU_ROUNDING = 8
ROUNDING_FLOOR = 1e-6
# train_card_vs_cpu_seeds: input seeds of the same three steps (~3 s
# each on an H100), 2 and 3 among them: there torch's own CUDA BatchNorm
# sums lie farther than 8x the CPU's error from their twin (PERF.md)
SPREAD_SEEDS = tuple(range(8))
SERVE_REQUESTS = 100  # timed requests per (batch, path): p90 has 10 beyond
WRN_CN_RECIPES = tuple(os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10",
                                    "wideresnet", name)
                       for name in ("cn.yaml", "cnsn.yaml"))
R50_CN_RECIPE = os.path.join(ROOT, "cnsn_tpu", "configs", "imagenet",
                             "resnet50", "cn.yaml")
R50_CN_STEPS = 5
# K1 per cn step of the reduced WRN (3 sites, sites 1 and 3 on): CrossNorm
# 'neither' takes its statistics at the 2 active sites; CNSN 'both' takes
# SelfNorm's at all 3 (CrossNorm's are masked, plain torch); the fused
# CNSN 'style' site takes CrossNorm's unmasked ones at all 3, on or not
CN_STEP_K1 = {"cn_neither": 2, "cnsn_both": 3, "cnsn_style": 3}
CN_STEP_BN = 7  # BatchNorm2d layers of WRN-10-2
SPIN_CYCLES = 2_000_000  # ~1 ms of card clock: host head start per launch
# phase trainer_wrn: cli train's epochs on the synthetic set (512 images:
# 4 steps at b=128); the timed Trainer's synthetic train set (40 steps) and
# test set (CIFAR-10's 10,000 test images: 10 eval batches of 1000); the
# trainer steps in each call of its profile
TRAINER_EPOCHS, TRAINER_TRAIN, TRAINER_TEST = 2, 5120, 10_000
TRAINER_PROFILE_STEPS = 4
EVAL_BATCH = 1000  # the recipes' eval_batch_size


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    """Fail the run (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each; the L2 is overwritten between launches (cold caller).
    A spin on the card before each start event lets the host enqueue
    ``fn`` ahead, so a slow host adds no gap inside the timed window."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(nbytes, flops, peak=FP32_FLOPS):
    """The least time the card could take, in ms, and what sets it: the
    bytes moved at the memory rate, or the operations at the peak of the
    unit that does them (fp32 for the stats and SelfNorm kernels, which
    use no tensor cores, and for K4's fp32 FMA path; bf16 tensor cores
    for K4's bf16 path)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The launch counters of K1 and K2 and the profile family of their kernels
# (utils/profiling.py): one kernel per launch each way
STATS_FAMILY = {"ins_stats": "ins_stats", "ins_stats_bwd": "ins_stats_bwd",
                "bn_sums": "bn_stats", "bn_sums_bwd": "bn_stats_bwd"}
# the kernel each counter launches (csrc/ins_stats.cu, csrc/bn_stats.cu)
STATS_KERNEL = {"ins_stats": "ins_stats_cluster_kernel",
                "ins_stats_bwd": "ins_bwd_stream_kernel",
                "bn_sums": "bn_sums_persistent_kernel",
                "bn_sums_bwd": "bn_bwd_stream_kernel"}


def check_stats_kernels(prof, want, what):
    """A profiled step ran K1's and K2's kernels once per launch that
    ``want`` (launches per step by counter) expects, and no other."""
    got = {k: prof["launches_by_family"].get(f, 0)
           for k, f in STATS_FAMILY.items()}
    exp = {k: want.get(k, 0) for k in STATS_FAMILY}
    check(got == exp, f"{what}: K1/K2 kernels per step {got}, expected "
          f"{exp}")


def phase_build():
    """Every library, one nvcc each, all started together."""
    from cnsn_tpu_torch.ops.kernels import LIBRARIES, build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    open(str(lib) + ".log").read().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, lib in libs.items()}
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: os.path.relpath(str(p), ROOT)
                        for n, p in libs.items()},
          "ptxas": ptxas})


def _row(kernel, shape, dtype, sites, err, tol, flush, run, plain,
         library, library_call, nbytes, flops, cn_sites=0, peak=FP32_FLOPS,
         **extra):
    """One kernel_vs_plain line: the error, then times on the card.
    ``sites``: launches at this shape per training step (K3: per serving
    forward); ``cn_sites``: launches added on a cn_image step."""
    k_ms = time_ms(run, 20, flush)
    p_ms = time_ms(plain, 10, flush)
    lib_ms = time_ms(library, 10, flush) if library is not None else None
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {"phase": "kernel_vs_plain", "kernel": kernel,
           "shape": list(shape), "dtype": str(dtype).split(".")[1],
           "sites": sites, "cn_sites": cn_sites, "max_abs_err": err,
           "tol": tol,
           "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / k_ms,
           "library_ms": lib_ms, "library_call": library_call, **extra}
    emit(row)
    return row


def phase_k3_vs_plain(dev, flush):
    """K3 at the 4 SelfNorm shapes of ResNet-50 at b=64 and b=1 (serving's
    batch and its latency case), at the 4 of WRN-40-2 at b=128 (its
    eval batch) and at the 3 of cnsn.yaml's pos 'post' at the trainer's
    eval batch of 1000, fp32 and bf16: the kernel selfnorm_path picks (the staged
    one at every such shape) against the plain version, bit for bit
    against itself run to run, with the v1 kernel checked and timed beside
    it through the forced path (v1_ms, v1_max_abs_err), and the staged
    kernel's plan."""
    from cnsn_tpu_torch.ops import (selfnorm_infer_cuda,
                                    selfnorm_infer_reference, selfnorm_path)
    from cnsn_tpu_torch.ops.kernels.selfnorm import PATHS, selfnorm_plan
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("resnet50", batch, shape) for batch in (BATCH, 1)
             for shape in SN_SHAPES]
    cases += [("wrn", 128, shape) for shape in WRN_SN_SHAPES]
    # the trainer's evaluation of cnsn.yaml (pos 'post') at eval_batch_size
    cases += [("wrn_eval", EVAL_BATCH, shape) for shape in WRN_POST_SHAPES]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for model, batch, (hw_side, c, sites) in cases:
            shape = (batch, hw_side, hw_side, c)
            x = (torch.randn(shape, generator=gen, device=dev) * 1.5
                 + 0.3).to(dtype)
            w = torch.randn(c, 2, generator=gen, device=dev) * 0.3
            a = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
            b = torch.randn(c, generator=gen, device=dev) * 0.1
            path = selfnorm_path(x)
            check(path == "staged", f"K3 {shape} {dtype} takes {path}")
            got = selfnorm_infer_cuda(x, w, a, b)
            again = selfnorm_infer_cuda(x, w, a, b)
            old = selfnorm_infer_cuda(x, w, a, b, path="v1")
            want = selfnorm_infer_reference(x, w, a, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])
            torch.testing.assert_close(old.float(), want.float(),
                                       **TOL[dtype])
            check(torch.isfinite(got).all().item(), f"finite K3 {shape}")
            check(torch.equal(got, again), f"K3 {shape} run to run")
            v1_err = (old.float() - want.float()).abs().max().item()
            del got, again, old, want
            rows.append(_row(
                PATHS[path][1], shape, dtype, sites, err, TOL[dtype],
                flush, lambda: selfnorm_infer_cuda(x, w, a, b),
                lambda: selfnorm_infer_reference(x, w, a, b), None,
                "null: no single PyTorch call computes the fused "
                "SelfNorm",
                2 * x.numel() * x.element_size() + 4 * c * 4,
                5 * x.numel(), path=path, model=model,
                plan=selfnorm_plan(x),
                v1_ms=time_ms(lambda: selfnorm_infer_cuda(
                    x, w, a, b, path="v1"), 20, flush),
                v1_max_abs_err=v1_err))
            del x
    torch.cuda.empty_cache()
    return rows


def phase_k1_vs_plain(dev, flush):
    """K1 forward and backward at the 16 SelfNorm sites of ResNet-50
    (b=128 bf16), at the image CrossNorm statistics (b=128 224² fp32, once
    per cn_image step; its backward is not on the path, no gradient
    reaches images), and at the calls of WRN-40-2's sn.yaml, cnsn.yaml
    and cn.yaml (b=128 32² bf16, ``WRN_K1_CASES``, each at its eps); the
    forward bit for bit run to run, each row with its plan (the
    backward's with ``equal_to_plain``: the same bits as the plain
    version)."""
    from cnsn_tpu_torch.ops import (ins_stats_bwd_cuda,
                                    ins_stats_bwd_reference, ins_stats_cuda,
                                    ins_stats_reference)
    from cnsn_tpu_torch.ops.kernels.ins_stats import (ins_bwd_plan_of,
                                                      ins_stats_plan_of)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    cases = [((n, n, c), torch.bfloat16, sites, 1e-5, {})
             for n, c, sites in SN_SHAPES]
    cases.append(((IMAGE, IMAGE, 3), torch.float32, 0, 1e-5, {}))
    for recipe, shapes, eps in WRN_K1_CASES:
        check(sum(r[2] for r in shapes) == WRN_SN, f"{recipe} K1 shapes")
        cases += [((n, n, c), torch.bfloat16, sites, eps,
                   {"model": "wrn", "recipe": recipe, "eps": eps})
                  for n, c, sites in shapes]
    for (h, w, c), dtype, sites, eps, tags in cases:
        shape = (128, h, w, c)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5
             + 0.3).to(dtype)
        elems, itemsize, stats = x.numel(), x.element_size(), 128 * c * 4
        got, want = ins_stats_cuda(x, eps), ins_stats_reference(x, eps)
        again = ins_stats_cuda(x, eps)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, want))
        # both sum fp32 in other orders: 1e-5 relative
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"K1 forward {shape} {dtype} run to run")
        rows.append(_row(
            "ins_stats", shape, dtype, sites, err,
            {"rtol": 1e-5, "atol": 1e-5}, flush,
            lambda: ins_stats_cuda(x, eps),
            lambda: ins_stats_reference(x, eps),
            lambda: torch.std_mean(x, dim=(1, 2)), "torch.std_mean",
            elems * itemsize + 2 * stats, 3 * elems,
            cn_sites=0 if sites else 1, plan=ins_stats_plan_of(x), **tags))
        mean, std = want
        gm = torch.randn(128, c, generator=gen, device=dev)
        gs = torch.randn(128, c, generator=gen, device=dev)
        got = ins_stats_bwd_cuda(x, mean, std, gm, gs)
        want = ins_stats_bwd_reference(x, mean, std, gm, gs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # one fp32 expression per element, rounded once to x's type
        rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-6
        check(err <= rel * want.float().abs().max().item(),
              f"K1 backward {shape} {dtype} eps {eps}: {err}")
        rows.append(_row(
            "ins_stats_bwd", shape, dtype, sites, err,
            {"of_max_abs": rel}, flush,
            lambda: ins_stats_bwd_cuda(x, mean, std, gm, gs),
            lambda: ins_stats_bwd_reference(x, mean, std, gm, gs), None,
            "null: no single PyTorch call computes this backward",
            2 * elems * itemsize + 4 * stats, 4 * elems,
            plan=ins_bwd_plan_of(x), equal_to_plain=torch.equal(got, want),
            **tags))
        del x, got, want, mean, std
    torch.cuda.empty_cache()
    return rows


def phase_k2_vs_plain(dev, flush):
    """K2 forward and backward at the 12 distinct BatchNorm2d input shapes
    of ResNet-50 at b=128 224² and the 4 of WRN-40-2 at b=128 32², bf16,
    with a warm running mean."""
    from cnsn_tpu_torch.ops import (bn_sums_bwd_cuda, bn_sums_bwd_reference,
                                    bn_sums_cuda, bn_sums_reference)
    from cnsn_tpu_torch.ops.kernels.bn_stats import (bn_bwd_plan_of,
                                                     bn_sums_plan)
    from cnsn_tpu_torch.utils.stats_sweep import bn_shapes
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    shapes = bn_shapes(IMAGE)
    check(len(shapes) == 12 and sum(shapes.values()) == BN_LAYERS,
          f"ResNet-50 BN shapes {dict(shapes)}")
    cases = [("resnet50", hw, c, sites) for (hw, c), sites in
             sorted(shapes.items(), key=lambda kv: -kv[0][0])]
    cases += [("wrn", hw, c, sites) for hw, c, sites in WRN_BN_SHAPES]
    check(sum(r[3] for r in cases if r[0] == "wrn") == WRN_BN,
          f"WRN-40-2 BN shapes {WRN_BN_SHAPES}")
    for model, hw, c, sites in cases:
        shape = (128, hw, hw, c)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5
             + 0.5).to(torch.bfloat16)
        m0 = torch.randn(c, generator=gen, device=dev) * 0.3
        elems = x.numel()
        s1, s2 = bn_sums_cuda(x, m0)
        a1, a2 = bn_sums_cuda(x, m0)
        w1, w2 = bn_sums_reference(x, m0)
        torch.cuda.synchronize()
        check(torch.equal(s1, a1) and torch.equal(s2, a2),
              f"K2 forward {shape} run to run")
        d_abs = (x.float() - m0).abs().sum(dim=(0, 1, 2))
        err = max((s1 - w1).abs().max().item(), (s2 - w2).abs().max().item())
        # the plain version adds up to 1.6M terms in fp32, the kernel in
        # fp64: 1e-5 of Σ|x−m0| (s1 may cancel to near 0) and of s2
        check(bool(((s1 - w1).abs() <= 1e-5 * d_abs).all())
              and bool(((s2 - w2).abs() <= 1e-5 * w2).all()),
              f"K2 forward {shape}: {err}")
        rows.append(_row(
            "bn_sums", shape, torch.bfloat16, sites, err,
            {"s1_of_sum_abs": 1e-5, "s2_rtol": 1e-5}, flush,
            lambda: bn_sums_cuda(x, m0), lambda: bn_sums_reference(x, m0),
            lambda: torch.var_mean(x, dim=(0, 1, 2)), "torch.var_mean",
            elems * 2 + 3 * c * 4, 4 * elems, model=model,
            plan=bn_sums_plan(x)))
        g1 = torch.randn(c, generator=gen, device=dev)
        g2 = torch.randn(c, generator=gen, device=dev) * 1e-3
        got = bn_sums_bwd_cuda(x, m0, g1, g2)
        want = bn_sums_bwd_reference(x, m0, g1, g2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # each product and sum rounded as the plain version rounds it
        check(err <= 2 ** -7 * want.float().abs().max().item(),
              f"K2 backward {shape}: {err}")
        rows.append(_row(
            "bn_sums_bwd", shape, torch.bfloat16, sites, err,
            {"of_max_abs": 2 ** -7}, flush,
            lambda: bn_sums_bwd_cuda(x, m0, g1, g2),
            lambda: bn_sums_bwd_reference(x, m0, g1, g2), None,
            "null: no single PyTorch call computes this backward",
            2 * elems * 2 + 3 * c * 4, 4 * elems, model=model,
            plan=bn_bwd_plan_of(x), equal_to_plain=torch.equal(got, want)))
        del x, got, want
    torch.cuda.empty_cache()
    return rows


def phase_k4_vs_plain(dev, flush):
    """K4 at b=128 at every stride-1 3x3 conv shape of WRN-40-2 (32²) and
    ResNet-50 (224²) in bf16, and one fp32 shape of each, against its
    plain version (error bound K4_TOL), bit for bit against itself run to
    run, with cuDNN's weight gradient on the same tensors as the library
    yardstick (TF32 off for fp32, as K4's fp32 path uses none).  Each row
    names the kernel that wgrad3x3_path chose; where that is the wgmma or
    the narrow kernel, the wmma kernel runs at the same shape through the
    forced path, held to the same bound and timed beside it (wmma_ms,
    wmma_max_abs_err), and the row carries the chosen kernel's plan (wgmma:
    its step box, stages, chunks and the bytes its TMA loads bring into
    shared memory; narrow: its band height, stages, blocks, the bytes its
    loads bring into shared memory and the bytes of its partials)."""
    from cnsn_tpu_torch.ops import (wgrad3x3_cuda, wgrad3x3_path,
                                    wgrad3x3_reference)
    from cnsn_tpu_torch.ops.kernels.conv_wgrad import (
        PATHS, wgrad3x3_narrow_plan, wgrad3x3_wgmma_plan)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    cases = [("wrn", s, torch.bfloat16) for s in K4_WRN]
    cases += [("resnet50", s, torch.bfloat16) for s in K4_R50]
    cases += [("wrn", K4_WRN[2], torch.float32),
              ("resnet50", K4_R50[2], torch.float32)]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for model, (hw, cin, cout, sites), dtype in cases:
        x = torch.randn(128, hw, hw, cin, generator=gen, device=dev).to(dtype)
        dy = torch.randn(128, hw, hw, cout, generator=gen,
                         device=dev).to(dtype)
        path = wgrad3x3_path(x, dy)
        got = wgrad3x3_cuda(x, dy)
        again = wgrad3x3_cuda(x, dy)
        want = wgrad3x3_reference(x, dy)
        scale = wgrad3x3_reference(x.abs(), dy.abs())
        torch.cuda.synchronize()
        err = (got - want).abs()
        worst = (err / scale.clamp_min(1e-30)).max().item()
        check(bool(torch.isfinite(got).all()), f"finite K4 {x.shape}")
        check(bool((err <= K4_TOL * scale).all()),
              f"K4 {path} {tuple(x.shape)}->{cout} {dtype}: {worst} of sum "
              f"|x||dy|")
        check(torch.equal(got, again), f"K4 {tuple(x.shape)} run to run")
        extra = {}
        if path != "wmma":
            old = wgrad3x3_cuda(x, dy, path="wmma")
            torch.cuda.synchronize()
            check(bool(((old - want).abs() <= K4_TOL * scale).all()),
                  f"K4 wmma {tuple(x.shape)}->{cout} {dtype}")
            extra["wmma_max_abs_err"] = (old - want).abs().max().item()
            del old
            extra["wmma_ms"] = time_ms(
                lambda: wgrad3x3_cuda(x, dy, path="wmma"), 20, flush)
            plan = (wgrad3x3_wgmma_plan if path == "wgmma"
                    else wgrad3x3_narrow_plan)
            extra["plan"] = plan(128, hw, hw, cin, cout)
        w = torch.empty(cout, cin, 3, 3, device=dev, dtype=dtype,
                        memory_format=torch.channels_last)
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        nbytes = ((x.numel() + dy.numel()) * x.element_size()
                  + 9 * cin * cout * 4)
        rows.append(_row(
            PATHS[path][1], (128, hw, hw, cin, cout), dtype, sites,
            err.max().item(), {"of_sum_abs_x_dy": K4_TOL}, flush,
            lambda: wgrad3x3_cuda(x, dy),
            lambda: wgrad3x3_reference(x, dy),
            lambda: torch.ops.aten.convolution_backward(
                dyc, xc, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False]),
            "aten.convolution_backward weight only (cuDNN wgrad)",
            nbytes, 2 * x.numel() * 9 * cout,
            peak=BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS,
            model=model, err_over_sum_abs=worst, path=path, **extra))
        del x, dy, got, again, want, scale, err
    torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return rows


def phase_model_vs_cpu(dev):
    from cnsn_tpu_torch import build_classifier
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(seed=0, pos="post", cnsn_type="sn")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(4, IMAGE, IMAGE, 3, generator=gen)
    cpu_model = build_classifier("resnet50", 1000, device="cpu", **kw)
    with torch.no_grad():
        want = cpu_model(images)
    del cpu_model
    model = build_classifier("resnet50", 1000, device=dev, **kw)
    with torch.no_grad():
        model(images.to(dev))  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        LAUNCHES.clear()
        got = model(images.to(dev))
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    got = got.cpu()
    check(got.shape == (4, 1000) and torch.isfinite(got).all().item(),
          "finite (4, 1000) logits")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    emit({"phase": "model_card_vs_cpu", "batch": 4, "dtype": "float32",
          "tf32": False, "max_abs_logit": scale, "max_abs_err": err,
          "err_over_scale": err / scale, "tol_over_scale": LOGIT_TOL,
          "selfnorm_launches_per_forward": launches})
    check(err <= LOGIT_TOL * scale, f"card vs CPU logits {err} > "
          f"{LOGIT_TOL} * {scale}")
    check(launches == {K3_STAGED: SN_SITES},
          f"{launches} K3 launches per forward, not {SN_SITES} staged")


def phase_serving(dev):
    """The main path: what a user runs to serve, counts read around it."""
    from cnsn_tpu_torch import build_classifier
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.serving import (export_classifier, load_artifact,
                                        save_artifact)
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    gen = torch.Generator().manual_seed(2)
    requests = [torch.randn(b, IMAGE, IMAGE, 3, generator=gen).to(dev)
                for b in (1, BATCH)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50_sn_bf16.pt2")
        LAUNCHES.clear()
        t0 = time.perf_counter()
        model = build_classifier("resnet50", 1000, device=dev, seed=0,
                                 pos="post", cnsn_type="sn",
                                 dtype=torch.bfloat16)
        save_artifact(export_classifier(model, IMAGE), path)
        serve = load_artifact(path, device=dev)
        export_s = time.perf_counter() - t0
        served = [serve(x) for x in requests]
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        artifact_bytes = os.path.getsize(path)
    emit({"phase": "serving_main_path", "export_save_load_s": export_s,
          "artifact_bytes": artifact_bytes, "batches": [1, BATCH],
          "launches": counts})
    check(counts == {K3_STAGED: SN_SITES * len(requests)},
          f"main path launches {counts}")

    for x, y in zip(requests, served):
        with torch.no_grad():
            eager = model(x)
        check(y.shape == (x.shape[0], 1000) and torch.isfinite(y).all().item(),
              f"finite served logits at b={x.shape[0]}")
        err = (y.float() - eager.float()).abs().max().item()
        scale = eager.float().abs().max().item()
        emit({"phase": "artifact_vs_eager", "batch": x.shape[0],
              "dtype": "bfloat16", "max_abs_err": err, "max_abs_logit": scale})
        # the artifact runs the same aten ops (conv2d, batch_norm, linear)
        # and the same SelfNorm kernel: equal unless cuDNN picks another
        # algorithm, which bf16 rounding would show far below this bound
        check(err <= ARTIFACT_TOL * scale,
              f"artifact vs eager {err} > {ARTIFACT_TOL} * {scale}")

    # closed loop, one request in flight: each forward timed to its sync
    rates = {}
    for b, x in zip((1, BATCH), requests):
        for name, fn in (("eager", model), ("artifact", serve)):
            with torch.no_grad():
                for _ in range(5):
                    fn(x)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                lat = []
                for _ in range(SERVE_REQUESTS):
                    t0 = time.perf_counter()
                    fn(x)
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
            lat.sort()
            med = statistics.median(lat)
            rates[(b, name)] = med
            emit({"phase": "serving_rate", "model": "resnet50 sn post",
                  "path": name, "batch": b, "image": IMAGE,
                  "dtype": "bfloat16", "requests": SERVE_REQUESTS,
                  "median_ms": med, "p90_ms": lat[int(0.9 * len(lat)) - 1],
                  "img_per_s": b / med * 1e3,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "card": nvidia_smi_name_power()})

    x = requests[1]
    for name, fn in (("eager", model), ("artifact", serve)):
        with torch.no_grad():
            prof = device_time_breakdown(lambda: fn(x), iters=5)
        # the profiler slows the host; idle share against the plain timing
        prof["idle_share_vs_unprofiled"] = (
            1.0 - prof["device_busy_ms"] / rates[(BATCH, name)])
        emit({"phase": "serving_profile", "path": name, "batch": BATCH,
              "dtype": "bfloat16", **prof})
    return counts


def phase_train_card_vs_cpu(dev):
    """Three SGD steps (plain, cn_image with a fixed permutation, plain) of
    a reduced-depth ResNet-50+SN (layers (1,1,1,1), full widths, b=4 64²,
    10 classes) in float32 with TF32 off, on the card and on the CPU, each
    held to a float64 twin on the CPU that replays its ReLU masks and
    max-pool choices (``cnsn_tpu_torch.train.rounding``).  Without the
    replay a single ReLU input within rounding of 0 changes a gradient
    element by its whole value (the line's ``step1_sign_flips``); with it,
    what is left is rounding, and the card's run may lie no farther from
    its twin than ``CARD_VS_CPU_ROUNDING`` times the CPU's run from its
    own: in each step's loss, and after steps 1 and 3 in the worst tensor
    of the state and of the momentum buffers (each over its max-abs)."""
    from cnsn_tpu_torch.train.rounding import (compare_runs, compare_traces,
                                               run_steps)
    f32, f64 = torch.float32, torch.float64
    card = run_steps(dev, f32, trace=True)
    cpu = run_steps("cpu", f32)
    errs = {"card": compare_runs(card, run_steps("cpu", f64,
                                                 replay=card.tape)),
            "cpu": compare_runs(cpu, run_steps("cpu", f64, replay=cpu.tape))}
    flips = {row["module"]: row["sign_flips"] for row in compare_traces(
        card, run_steps("cpu", f64, trace=True)) if row.get("sign_flips")}
    finite = all(bool(torch.isfinite(v).all())
                 for v in card.states[3].values())
    emit({"phase": "train_card_vs_cpu", "model": "resnet50 layers (1,1,1,1)"
          " sn post", "batch": 4, "image": 64, "dtype": "float32",
          "tf32": False, "losses_card": card.losses, "losses_cpu": cpu.losses,
          "vs_replaying_float64": errs, "step1_sign_flips": flips,
          "bound": f"card <= {CARD_VS_CPU_ROUNDING} x max(cpu, "
                   f"{ROUNDING_FLOOR})", "finite": finite})
    check(finite, "finite parameters after three card steps")
    for key, cpu_err in errs["cpu"].items():
        card_err = errs["card"][key]
        pairs = (zip(card_err, cpu_err) if key == "loss_rel_err"
                 else [(card_err[0], cpu_err[0])])
        for got, ref in pairs:
            check(got <= CARD_VS_CPU_ROUNDING * max(ref, ROUNDING_FLOOR),
                  f"card vs float64 {key}: {got} against the CPU's {ref}")


def phase_train_card_vs_cpu_seeds(dev):
    """``train_card_vs_cpu``'s three steps at each of ``SPREAD_SEEDS``
    (``cnsn_tpu_torch.train.rounding.seed_spread``): per seed, four
    float32 runs against their mask-replaying float64 twins, the card's
    (K1, K2) and three witnesses (the CPU's, and the card's with torch's
    and with exact BatchNorm sums).  The card's run may lie no farther
    from its twin than ``CARD_VS_CPU_ROUNDING`` times the largest
    witness's error (``seed_bounds``), in each loss and after steps 1 and
    3 in the worst tensor of the state and of the momentum.  The
    witnesses round the same steps in other orders, so the bound follows
    what rounding alone does at each seed, where ``train_card_vs_cpu``'s
    rests on the CPU's error at one seed."""
    from cnsn_tpu_torch.train.rounding import seed_bounds, seed_spread
    t0 = time.perf_counter()
    rows = seed_spread(SPREAD_SEEDS)
    seconds = time.perf_counter() - t0
    worst, over = {}, []
    for row in rows:
        bounds = seed_bounds(row, CARD_VS_CPU_ROUNDING, ROUNDING_FLOOR)
        worst[row["seed"]] = max(bounds, key=lambda q: q[1] / q[2])
        over += [(row["seed"], *q) for q in bounds if not q[1] <= q[2]]
    emit({"phase": "train_card_vs_cpu_seeds", "seeds": list(SPREAD_SEEDS),
          "bound": f"card <= {CARD_VS_CPU_ROUNDING} x max(cpu, "
                   f"card_torch_sums, card_exact_bn_sums, {ROUNDING_FLOOR})",
          "worst_by_seed": {seed: {"quantity": q, "card": g, "bound": b,
                                   "share": g / b}
                            for seed, (q, g, b) in worst.items()},
          "seconds": seconds})
    check(not over, f"card vs float64 over several seeds: {over}")


def train_flops_per_step(model, batch, image=IMAGE):
    """Analytic FLOPs of one training step: 2 per multiply-add of every
    conv and the fc, three times (forward, input gradient, weight
    gradient), less the stem's input gradient, which nothing needs.  The
    normalisation and elementwise work is not counted."""
    from cnsn_tpu_torch.models.common import Conv2d, Linear
    macs = {}

    def hook(module, inputs, out):
        if isinstance(module, Conv2d):
            _, cin, k, _ = module.weight.shape
            macs[module] = out[0].numel() * cin * k * k
        else:
            macs[module] = out[0].numel() * module.weight.shape[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2d, Linear))]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, image, image, 3,
                                     device=next(model.parameters()).device))
    finally:
        for h in handles:
            h.remove()
        model.train()
    total = sum(macs.values())
    return batch * 2 * (3 * total - macs[model.conv1])


@contextlib.contextmanager
def conv3x3_mode(mode):
    """CNSN_CONV3X3 while the models of a phase are built (the factory
    reads it then), restored after."""
    old = os.environ.get("CNSN_CONV3X3")
    os.environ["CNSN_CONV3X3"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["CNSN_CONV3X3"]
        else:
            os.environ["CNSN_CONV3X3"] = old


def flagship(dev, recipe=RECIPE):
    """The flagship recipe's (or another ImageNet cn_image recipe's) train
    state and step, b=128 224² bf16, built as a user builds it;
    ``step(cn)`` runs a cn_image or a plain step."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.train import (StepFns, create_train_state,
                                      imagenet_step_lr)
    cfg = load_config(recipe, compute_dtype="bf16")
    check(cfg.regime == "cn_image" and cfg.schedule == "imagenet_step",
          f"recipe resolves to {cfg.regime}, {cfg.schedule}")
    model = build_model(cfg.model, cfg.num_classes,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                        cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16)
    state = create_train_state(
        model, imagenet_step_lr(cfg.lr, cfg.epochs, cfg.batch_size,
                                STEPS_PER_EPOCH),
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        nesterov=cfg.nesterov, device=dev)
    steps = StepFns(image_crop=cfg.crop, image_beta=cfg.beta)
    b = cfg.batch_size
    gen = torch.Generator().manual_seed(cfg.seed)
    images = torch.randn(b, IMAGE, IMAGE, 3, generator=gen).to(dev)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen).to(dev)
    # the pairing is drawn on the card; a crop's boxes only on the host
    perm_gen = torch.Generator(
        device=dev if cfg.crop == "neither" else "cpu").manual_seed(cfg.seed)
    gates = np.random.RandomState(GATE_SEED).rand(TRAIN_STEPS) < cfg.cn_prob

    def step(cn):
        if cn:
            return steps.cn_image(state, images, labels, generator=perm_gen)
        return steps.plain(state, images, labels)

    return cfg, state, steps, step, gates, images, labels


def phase_train(dev):
    """The training main path: the flagship recipe at full width, b=128
    224² bf16, 35 gated steps timed as bench.py times them, with every
    kernel launch counted; profiles of a plain and a cn_image step; then
    one b=64 eval step through K3."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    cfg, state, steps, step, gates, images, labels = flagship(dev)
    b = cfg.batch_size
    flops = train_flops_per_step(state.model, b)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    losses, window_ms = [], []
    t0 = time.perf_counter()
    for i in range(WARMUP):
        losses.append(step(gates[i])[1]["loss"])
    float(losses[-1])  # the host waits for the step, as bench.py does
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for w in range(WINDOWS):
        t0 = time.perf_counter()
        for i in range(WARMUP + w * WINDOW, WARMUP + (w + 1) * WINDOW):
            losses.append(step(gates[i])[1]["loss"])
        float(losses[-1])
        window_ms.append((time.perf_counter() - t0) * 1e3 / WINDOW)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_cn = int(gates.sum())
    want = {"bn_sums": BN_LAYERS * TRAIN_STEPS,
            "bn_sums_bwd": BN_LAYERS * TRAIN_STEPS,
            "ins_stats": SN_SITES * TRAIN_STEPS + n_cn,
            "ins_stats_bwd": SN_SITES * TRAIN_STEPS}
    losses = torch.stack(losses).float().cpu()
    emit({"phase": "train_main_path", "recipe": os.path.relpath(RECIPE, ROOT),
          "regime": cfg.regime, "batch": b, "image": IMAGE,
          "dtype": "bfloat16", "steps": TRAIN_STEPS, "cn_image_steps": n_cn,
          "gates": [int(g) for g in gates], "launches": counts,
          "expected": want, "loss_first": losses[0].item(),
          "loss_last": losses[-1].item(),
          "losses_finite": bool(torch.isfinite(losses).all())})
    check(counts == want, f"training launches {counts}, expected {want}")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")

    med = statistics.median(window_ms)
    emit({"phase": "train_rate", "model": "resnet50 sn post",
          "recipe": "cnsn.yaml", "batch": b, "image": IMAGE,
          "dtype": "bfloat16", "warmup_steps": WARMUP,
          "warmup_s": warmup_s, "windows_ms_per_step": window_ms,
          "ms_per_step": med, "img_per_s": b / med * 1e3,
          "spread_img_per_s": b * 1e3 * (1 / min(window_ms)
                                         - 1 / max(window_ms)),
          "flops_per_step": flops,
          "bf16_peak_share": flops / (med / 1e3) / BF16_FLOPS,
          "peak_mem_gib": peak, "host_loadavg": os.getloadavg(),
          "card": nvidia_smi_name_power()})

    for kind in ("plain", "cn_image"):
        prof = device_time_breakdown(lambda: step(kind == "cn_image"),
                                     iters=3, warmup=1, top=12)
        # the profiler slows the host; idle share against the plain timing
        prof["idle_share_vs_unprofiled"] = 1.0 - prof["device_busy_ms"] / med
        emit({"phase": "train_profile", "step": kind, "batch": b,
              "dtype": "bfloat16", **prof})
        # K1 and K2 are one kernel per launch: K2 one per BatchNorm2d
        # layer each way, K1 one per SelfNorm site each way (and one more
        # forward, the image statistics, on a cn_image step)
        check_stats_kernels(
            prof, {"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS,
                   "ins_stats": SN_SITES + (kind == "cn_image"),
                   "ins_stats_bwd": SN_SITES}, f"flagship {kind} step")

    LAUNCHES.clear()
    out = steps.eval_step(state, images[:BATCH], labels[:BATCH])
    torch.cuda.synchronize()
    k3 = dict(LAUNCHES)
    logits = out["logits"]
    emit({"phase": "train_then_eval", "batch": BATCH, "launches": k3,
          "loss": out["loss"].item(), "correct": out["correct"].item()})
    check(k3 == {K3_STAGED: SN_SITES}, f"eval launches {k3}")
    check(logits.shape == (BATCH, 1000)
          and bool(torch.isfinite(logits).all()), "finite eval logits")
    del state, images
    torch.cuda.empty_cache()
    return counts, n_cn, med


def step_launches(step, per_step):
    """Run ``step()`` and append the launches it made, by kernel."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    before = dict(LAUNCHES)
    out = step()
    per_step.append({k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                     if v != before.get(k, 0)})
    return out


def timed_windows(step):
    """``step(i)`` for i in range(TRAIN_STEPS), timed as bench.py times
    its loop: WARMUP steps, then WINDOWS windows of WINDOW steps, the host
    waiting for each window's last loss; the launches of each step
    (``step_launches``), the peak memory counted from the first window.
    Returns (launches per step, losses on the host, ms per step of each
    window, warm-up seconds)."""
    per_step, losses, window_ms = [], [], []

    def one(i):
        losses.append(step_launches(lambda: step(i), per_step)[1]["loss"])

    t0 = time.perf_counter()
    for i in range(WARMUP):
        one(i)
    float(losses[-1])
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for w in range(WINDOWS):
        t0 = time.perf_counter()
        for i in range(WARMUP + w * WINDOW, WARMUP + (w + 1) * WINDOW):
            one(i)
        float(losses[-1])
        window_ms.append((time.perf_counter() - t0) * 1e3 / WINDOW)
    torch.cuda.synchronize()
    return per_step, torch.stack(losses).float().cpu(), window_ms, warmup_s


def phase_train_flagship_k4(dev, conv_ms, k4_rows):
    """The flagship recipe again, for FLAGSHIP_K4_STEPS steps (the first
    gates of phase_train's sequence) with CNSN_CONV3X3=pallas: 13 K4
    launches per step, every one through the wgmma kernel, beside the
    other kernels' counts, the step time of the last three beside
    phase_train's (cuDNN's gradients), and a profile of one plain step.
    Returns K4's launches and its times per step from k4_rows."""
    from cnsn_tpu_torch.ops.convdot import LAYOUT_COPIES
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    with conv3x3_mode("pallas"):
        cfg, state, _, step, gates, images, _ = flagship(dev)
    n = FLAGSHIP_K4_STEPS
    torch.cuda.synchronize()
    LAUNCHES.clear()
    LAYOUT_COPIES.clear()
    per_step, losses = [], []
    for i in range(n):
        if i == 2:
            float(losses[-1])
            t0 = time.perf_counter()
        losses.append(step_launches(lambda: step(gates[i]),
                                    per_step)[1]["loss"])
    float(losses[-1])
    ms = (time.perf_counter() - t0) * 1e3 / (n - 2)
    counts, copies = dict(LAUNCHES), dict(LAYOUT_COPIES)
    want = [{"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS,
             "ins_stats": SN_SITES + int(g), "ins_stats_bwd": SN_SITES,
             K4_WGMMA: R50_K4} for g in gates[:n]]
    losses = torch.stack(losses).float().cpu()
    k4_rows = [r for r in k4_rows if r["model"] == "resnet50"
               and r["dtype"] == "bfloat16"]
    k4 = {"launches": counts.get(K4_WGMMA, 0), "steps": n}
    for key in ("kernel_ms", "bound_ms", "plain_ms", "library_ms", "wmma_ms"):
        k4[key] = sum(r[key] * r["sites"] for r in k4_rows)
    emit({"phase": "train_flagship_k4", "conv3x3": "pallas",
          "batch": cfg.batch_size, "image": IMAGE, "dtype": "bfloat16",
          "steps": n, "launches": counts, "per_step_launches": per_step,
          "k4_layout_copies": copies,
          "ms_per_step_last3": ms, "img_per_s": cfg.batch_size / ms * 1e3,
          "conv_mode_ms_per_step": conv_ms,
          "k4_kernel_ms_per_step": k4["kernel_ms"],
          "k4_wmma_ms_per_step": k4["wmma_ms"],
          "k4_bound_ms_per_step": k4["bound_ms"],
          "cudnn_wgrad_ms_per_step": k4["library_ms"],
          "losses": losses.tolist(), "card": nvidia_smi_name_power()})
    check(per_step == want, f"flagship K4 launches {per_step}, expected "
          f"{want}")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
    prof = device_time_breakdown(lambda: step(False), iters=2, warmup=1,
                                 top=12)
    prof["idle_share_vs_unprofiled"] = 1.0 - prof["device_busy_ms"] / ms
    emit({"phase": "train_flagship_k4_profile", "step": "plain",
          "conv3x3": "pallas", "batch": cfg.batch_size, "dtype": "bfloat16",
          **prof})
    check_stats_kernels(prof, {**want[0], "ins_stats": SN_SITES},
                        "flagship plain step under pallas")
    del state, images
    torch.cuda.empty_cache()
    return k4


def phase_wrn_k4_vs_cudnn(dev):
    """One float32 SGD step of a reduced WRN (depth 10, widen 2, SN pre,
    b=32 32²) on the card, TF32 off and cuDNN deterministic, from the
    same weights under CNSN_CONV3X3=pallas and =conv.  The forwards are
    the same kernels, so the losses are equal; so is every dy that
    reaches a conv.  K4's weight gradients are held to cuDNN's within
    K4_TOL of Σ|x|·|dy| (read from that conv's x and dy); the other convs
    (stride 2, 1x1 shortcut) take cuDNN's gradient in both runs."""
    from cnsn_tpu_torch.models.common import Conv2d
    from cnsn_tpu_torch.models.wideresnet import WideResNet
    from cnsn_tpu_torch.ops import wgrad3x3_reference
    from cnsn_tpu_torch.ops.convdot import routes_to_k4
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train import StepFns, create_train_state
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(32, WRN_IMAGE, WRN_IMAGE, 3, generator=gen).to(dev)
    labels = torch.randint(0, 10, (32,), generator=gen).to(dev)
    runs = {}
    for mode in ("pallas", "conv"):
        with conv3x3_mode(mode):
            model = WideResNet(depth=10, widen_factor=2, pos="pre",
                               cnsn_type="sn",
                               generator=torch.Generator().manual_seed(5))
        state = create_train_state(model, lambda step: 0.1, device=dev)
        convs = {n: m for n, m in state.model.named_modules()
                 if isinstance(m, Conv2d)}
        seen = {}

        def hook(name):
            def fn(module, inputs, out):
                seen[name] = [inputs[0].detach(), None]
                out.register_hook(lambda g: seen[name].__setitem__(1, g))
            return fn

        handles = [m.register_forward_hook(hook(n)) for n, m in convs.items()]
        LAUNCHES.clear()
        _, metrics = StepFns().plain(state, images, labels)
        torch.cuda.synchronize()
        for h in handles:
            h.remove()
        k4 = {n for n, m in convs.items() if routes_to_k4(
            getattr(m, "wgrad", "auto"), m.stride, m.weight.shape[2:],
            seen[n][0].shape[2], seen[n][0].shape[3], m.weight.shape[1],
            m.weight.shape[0])}
        runs[mode] = dict(loss=metrics["loss"].item(), k4=k4, seen=seen,
                          launches=sum(LAUNCHES[k] for k in K4_KERNELS),
                          grads={n: m.weight.grad.clone()
                                 for n, m in convs.items()})
        del state, model
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.deterministic = flags
    p, c = runs["pallas"], runs["conv"]
    layers = {}
    for name, gc in c["grads"].items():
        gp = p["grads"][name]
        err = (gp - gc).abs()
        row = {"k4": name in p["k4"], "max_abs_err": err.max().item(),
               "max_abs_grad": gc.abs().max().item(),
               "bit_equal": torch.equal(gp, gc)}
        if row["k4"]:
            x, dy = p["seen"][name]
            scale = wgrad3x3_reference(
                x.permute(0, 2, 3, 1).abs(),
                dy.permute(0, 2, 3, 1).abs()).permute(3, 2, 0, 1)
            row["err_over_sum_abs"] = (err / scale.clamp_min(1e-30)).max().item()
            row["ok"] = bool((err <= K4_TOL * scale).all())
        else:
            # cuDNN in both runs, float32, deterministic
            row["ok"] = row["max_abs_err"] <= 1e-5 * row["max_abs_grad"]
        layers[name] = row
    emit({"phase": "wrn_k4_vs_cudnn", "model": "wideresnet depth 10 "
          "widen 2 sn pre", "batch": 32, "image": WRN_IMAGE,
          "dtype": "float32", "tf32": False, "loss_pallas": p["loss"],
          "loss_conv": c["loss"], "k4_launches": p["launches"],
          "tol": f"K4 convs: {K4_TOL} of sum |x||dy|; others 1e-5 of max",
          "layers": layers})
    check(p["loss"] == c["loss"], f"losses {p['loss']} vs {c['loss']}")
    check(p["launches"] == len(p["k4"]) == 5 and c["launches"] == 0,
          f"K4 launches {p['launches']} ({sorted(p['k4'])}) and "
          f"{c['launches']}")
    bad = [n for n, r in layers.items() if not r["ok"]]
    check(not bad, f"conv weight gradients differ: {bad}")
    torch.cuda.empty_cache()


def phase_train_wrn(dev):
    """The CIFAR main path: sn.yaml (WRN-40-2, SelfNorm pos='pre', plain
    regime, nesterov SGD, wd 5e-4, cosine LR over 100 epochs of 390
    steps) at b=128 32² bf16, 35 steps timed as phase_train times them,
    first with CNSN_CONV3X3=pallas (K4 on every stride-1 3x3 conv), then
    with cuDNN's gradients; the launches checked step by step; a profile
    of one step under each; then one eval step through K3."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.ops.convdot import LAYOUT_COPIES
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    cfg = load_config(WRN_RECIPE, compute_dtype="bf16")
    check((cfg.model, cfg.regime, cfg.schedule, cfg.pos, cfg.cnsn_type)
          == ("wideresnet", "plain", "cosine", "pre", "sn"),
          f"sn.yaml resolves to {cfg}")
    b = cfg.batch_size
    gen = torch.Generator().manual_seed(cfg.seed)
    images = torch.randn(b, WRN_IMAGE, WRN_IMAGE, 3, generator=gen).to(dev)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen).to(dev)
    rates, wrn_counts = {}, None
    for mode in ("pallas", "conv"):
        with conv3x3_mode(mode):
            model = build_model(
                cfg.model, cfg.num_classes,
                generator=torch.Generator().manual_seed(cfg.seed),
                pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16)
        state = create_train_state(
            model, cosine_lr(cfg.lr, cfg.epochs * WRN_STEPS_PER_EPOCH),
            momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            nesterov=cfg.nesterov, device=dev)
        steps = StepFns()
        flops = train_flops_per_step(state.model, b, WRN_IMAGE)
        want = {"bn_sums": WRN_BN, "bn_sums_bwd": WRN_BN,
                "ins_stats": WRN_SN, "ins_stats_bwd": WRN_SN}
        if mode == "pallas":
            want[K4_WGMMA] = WRN_K4_WGMMA
            want[K4_NARROW] = WRN_K4_NARROW
        torch.cuda.synchronize()
        LAUNCHES.clear()
        LAYOUT_COPIES.clear()
        per_step, losses, window_ms, warmup_s = timed_windows(
            lambda i: steps.plain(state, images, labels))
        counts, copies = dict(LAUNCHES), dict(LAYOUT_COPIES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(window_ms)
        rates[mode] = med
        emit({"phase": "train_wrn", "recipe": os.path.relpath(WRN_RECIPE,
                                                               ROOT),
              "conv3x3": mode, "regime": cfg.regime, "batch": b,
              "image": WRN_IMAGE, "dtype": "bfloat16", "steps": TRAIN_STEPS,
              "launches": counts, "expected_per_step": want,
              "k4_layout_copies": copies, "loss_first": losses[0].item(),
              "loss_last": losses[-1].item(),
              "losses_finite": bool(torch.isfinite(losses).all()),
              "warmup_s": warmup_s, "windows_ms_per_step": window_ms,
              "ms_per_step": med, "img_per_s": b / med * 1e3,
              "flops_per_step": flops,
              "bf16_peak_share": flops / (med / 1e3) / BF16_FLOPS,
              "peak_mem_gib": peak, "host_loadavg": os.getloadavg(),
              "card": nvidia_smi_name_power()})
        # no launch of the wmma kernel: per_step and counts list only
        # the kernels that ran
        check(all(d == want for d in per_step),
              f"WRN launches per step {per_step}, expected {want}")
        check(counts == {k: v * TRAIN_STEPS for k, v in want.items()},
              f"WRN launches {counts}")
        check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
        prof = device_time_breakdown(
            lambda: steps.plain(state, images, labels), iters=3, warmup=1,
            top=12)
        prof["idle_share_vs_unprofiled"] = 1.0 - prof["device_busy_ms"] / med
        emit({"phase": "train_wrn_profile", "conv3x3": mode, "batch": b,
              "dtype": "bfloat16", **prof})
        check_stats_kernels(prof, want, f"WRN sn.yaml step under {mode}")
        if mode == "pallas":
            wrn_counts = counts
            LAUNCHES.clear()
            out = steps.eval_step(state, images, labels)
            torch.cuda.synchronize()
            k3 = dict(LAUNCHES)
            emit({"phase": "train_wrn_then_eval", "batch": b, "launches": k3,
                  "loss": out["loss"].item(),
                  "correct": out["correct"].item()})
            check(k3 == {K3_STAGED: WRN_SN}, f"WRN eval launches {k3}")
            check(out["logits"].shape == (b, cfg.num_classes)
                  and bool(torch.isfinite(out["logits"]).all()),
                  "finite WRN eval logits")
        del state, model
        torch.cuda.empty_cache()
    emit({"phase": "train_wrn_rates", "ms_per_step_pallas": rates["pallas"],
          "ms_per_step_conv": rates["conv"],
          "img_per_s_pallas": b / rates["pallas"] * 1e3,
          "img_per_s_conv": b / rates["conv"] * 1e3,
          "card": nvidia_smi_name_power()})
    return wrn_counts


def phase_cn_card_vs_cpu(dev):
    """One cn step of a reduced WRN (depth 10, widen 2, pos 'post', b=8
    32², float32, TF32 off) with fixed draws (sites 1 and 3 on, each
    site's permutation and boxes from a seed: ``train/rounding.py``'s
    ``run_cn_step``), for CrossNorm 'neither' (K1 and its backward at the
    active sites), CNSN 'both' (masked statistics) and CNSN 'style' (the
    fused site), on the card and on the CPU.  Each run is held to a
    float64 twin on the CPU that replays its ReLU masks; the card's error
    may be at most ``CARD_VS_CPU_ROUNDING`` times the CPU's (floored at
    ``ROUNDING_FLOOR``), as in train_card_vs_cpu: in the loss, and in the
    worst tensor of the state and of the momentum buffers after the
    step.  The card's K1 and K2 launches are checked."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train.rounding import (CN_KNOBS, CN_MASK,
                                               compare_runs, run_cn_step)
    f32, f64 = torch.float32, torch.float64
    for knobs in CN_KNOBS:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        card = run_cn_step(dev, f32, knobs)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        cpu = run_cn_step("cpu", f32, knobs)
        errs = {name: compare_runs(run, run_cn_step(
            "cpu", f64, knobs, replay=run.tape))
            for name, run in (("card", card), ("cpu", cpu))}
        finite = all(bool(torch.isfinite(v).all())
                     for v in card.states[1].values())
        k1 = CN_STEP_K1[knobs]
        want = {"bn_sums": CN_STEP_BN, "bn_sums_bwd": CN_STEP_BN,
                "ins_stats": k1, "ins_stats_bwd": k1}
        emit({"phase": "cn_card_vs_cpu", "knobs": knobs,
              "model": "wideresnet depth 10 widen 2 pos post", "batch": 8,
              "image": 32, "dtype": "float32", "tf32": False,
              "mask": list(CN_MASK), "loss_card": card.losses[0],
              "loss_cpu": cpu.losses[0], "vs_replaying_float64": errs,
              "bound": f"card <= {CARD_VS_CPU_ROUNDING} x max(cpu, "
                       f"{ROUNDING_FLOOR})", "launches": launches,
              "expected_launches": want, "finite": finite})
        check(finite, f"finite parameters after the {knobs} cn step")
        check(launches == want, f"{knobs} cn step launches {launches}, "
              f"expected {want}")
        for key, cpu_err in errs["cpu"].items():
            # the loss's one-step list, or a tensor's (error, name)
            got, ref = errs["card"][key][0], cpu_err[0]
            check(got <= CARD_VS_CPU_ROUNDING * max(ref, ROUNDING_FLOOR),
                  f"{knobs} card vs float64 {key}: {got} against the "
                  f"CPU's {ref}")


def phase_train_wrn_cn(dev):
    """The CIFAR cn regime at full width: cn.yaml (CrossNorm 'neither' at
    pos 'post', cn_prob 0.5) and cnsn.yaml (CNSN 'both', cn_prob 0.25),
    each WRN-40-2 at b=128 32² bf16 under CNSN_CONV3X3=pallas, 2 of the
    18 sites on per cn step, 35 steps gated by
    ``RandomState(GATE_SEED).rand(35) < cn_prob`` (cn or plain, as
    ``cnsn_tpu/train/trainer.py:263-264`` picks) and timed as phase_train
    times them, the launches checked step by step, one cn step of each
    profiled; then one eval step of the cnsn.yaml model through K3.  The
    site masks and boxes are drawn on the host from a CPU generator.
    Returns each recipe's launches over its 35 steps and its median ms
    per step."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    out, rates = {}, {}
    for recipe in WRN_CN_RECIPES:
        name = os.path.basename(recipe)
        cfg = load_config(recipe, compute_dtype="bf16")
        check((cfg.model, cfg.regime, cfg.pos, cfg.active_num)
              == ("wideresnet", "cn", "post", 2), f"{name} resolves to {cfg}")
        b = cfg.batch_size
        gen = torch.Generator().manual_seed(cfg.seed)
        images = torch.randn(b, WRN_IMAGE, WRN_IMAGE, 3, generator=gen).to(dev)
        labels = torch.randint(0, cfg.num_classes, (b,),
                               generator=gen).to(dev)
        with conv3x3_mode("pallas"):
            model = build_model(
                cfg.model, cfg.num_classes,
                generator=torch.Generator().manual_seed(cfg.seed),
                pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16)
        state = create_train_state(
            model, cosine_lr(cfg.lr, cfg.epochs * WRN_STEPS_PER_EPOCH),
            momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            nesterov=cfg.nesterov, device=dev)
        check(state.model.cn_num == WRN_SN, f"{name} cn_num")
        steps = StepFns(active_num=cfg.active_num, image_crop=cfg.crop,
                        image_beta=cfg.beta)
        draws = torch.Generator().manual_seed(cfg.seed)
        gates = np.random.RandomState(GATE_SEED).rand(TRAIN_STEPS) < \
            cfg.cn_prob

        def step(cn):
            if cn:
                return steps.cn(state, images, labels, generator=draws)
            return steps.plain(state, images, labels)

        base = {"bn_sums": WRN_BN, "bn_sums_bwd": WRN_BN,
                K4_WGMMA: WRN_K4_WGMMA, K4_NARROW: WRN_K4_NARROW}
        sn = WRN_SN if "sn" in cfg.cnsn_type else 0
        want = [{**base, "ins_stats": sn + 2 * (cfg.cnsn_type == "cn") * g,
                 "ins_stats_bwd": sn + 2 * (cfg.cnsn_type == "cn") * g}
                for g in gates]
        want = [{k: v for k, v in w.items() if v} for w in want]
        torch.cuda.synchronize()
        LAUNCHES.clear()
        per_step, losses, window_ms, warmup_s = timed_windows(
            lambda i: step(gates[i]))
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(window_ms)
        n_cn = int(gates.sum())
        emit({"phase": "train_wrn_cn", "recipe": os.path.relpath(recipe,
                                                                  ROOT),
              "regime": cfg.regime, "cnsn_type": cfg.cnsn_type,
              "crop": cfg.crop, "cn_prob": cfg.cn_prob,
              "active_num": cfg.active_num, "conv3x3": "pallas",
              "batch": b, "image": WRN_IMAGE, "dtype": "bfloat16",
              "steps": TRAIN_STEPS, "cn_steps": n_cn,
              "gates": [int(g) for g in gates], "launches": counts,
              "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
              "losses_finite": bool(torch.isfinite(losses).all()),
              "warmup_s": warmup_s, "windows_ms_per_step": window_ms,
              "ms_per_step": med, "img_per_s": b / med * 1e3,
              "peak_mem_gib": peak, "host_loadavg": os.getloadavg(),
              "card": nvidia_smi_name_power()})
        bad = [(i, got, exp) for i, (got, exp) in
               enumerate(zip(per_step, want)) if got != exp]
        check(not bad, f"{name} launches per step (step, got, expected): "
              f"{bad[:3]}")
        check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
        prof = device_time_breakdown(lambda: step(True), iters=3, warmup=1,
                                     top=12)
        prof["idle_share_vs_unprofiled"] = 1.0 - prof["device_busy_ms"] / med
        emit({"phase": "train_wrn_cn_profile", "recipe": name, "step": "cn",
              "batch": b, "dtype": "bfloat16", **prof})
        cn_step = {**base, "ins_stats": sn + 2 * (cfg.cnsn_type == "cn"),
                   "ins_stats_bwd": sn + 2 * (cfg.cnsn_type == "cn")}
        check_stats_kernels(prof, cn_step, f"{name} cn step")
        if "sn" in cfg.cnsn_type:
            LAUNCHES.clear()
            ev = steps.eval_step(state, images, labels)
            torch.cuda.synchronize()
            k3 = dict(LAUNCHES)
            emit({"phase": "train_wrn_cn_then_eval", "recipe": name,
                  "batch": b, "launches": k3, "loss": ev["loss"].item(),
                  "correct": ev["correct"].item()})
            check(k3 == {K3_STAGED: WRN_SN}, f"{name} eval launches {k3}")
            check(ev["logits"].shape == (b, cfg.num_classes)
                  and bool(torch.isfinite(ev["logits"]).all()),
                  f"finite {name} eval logits")
        out[name], rates[name] = counts, med
        del state, model, images
        torch.cuda.empty_cache()
    return out, rates


def _cli(argv, log):
    """``cnsn_tpu_torch.cli.main(argv)`` in this process, its printed
    output appended to ``log`` and returned."""
    from cnsn_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    with open(log, "a") as f:
        f.write(f"$ cli {' '.join(argv)}\n{buf.getvalue()}")
    return buf.getvalue()


def phase_trainer_wrn(dev, step_ms, cnsn_counts):
    """The host side of CIFAR training at full width: cnsn.yaml (WRN-40-2
    + CNSN 'both', b=128 32² bf16, CNSN_CONV3X3=pallas) on the synthetic
    set, driven as a user drives it.

    (a) ``cli train`` for TRAINER_EPOCHS epochs (4 steps and one eval of
    the 512 test images each): the exp dir's files and log.txt's rows;
    ``cli eval resume=<last>`` prints the last row's Test Error exactly;
    ``cli export resume=<last>`` serves logits within ARTIFACT_TOL of the
    checkpoint's eager eval forward.
    (b) a ``Trainer`` from the same recipe (its 100 epochs, so the LR is at
    the cosine's start), its loaders replaced by the synthetic set at
    TRAINER_TRAIN images (40 steps) and TRAINER_TEST (10 batches of 1000,
    CIFAR-10's test size): one epoch and one evaluation timed, the
    launches of each checked against ``cnsn_counts`` (train_wrn_cn's
    cnsn.yaml run) and 18 K3 launches per eval batch, beside the loader's
    host time per batch alone, the wait for each staged batch, the
    step-only rate of train_wrn_cn (``step_ms``), the same epoch with the
    loader inline (prefetch_depth 0) and with one made batch fed to every
    step, and one profile of a few trainer steps.  The trainer's own
    printing goes to chiprun_out/trainer_wrn/cli.txt."""
    from cnsn_tpu_torch import build_classifier
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.data import (CifarLoader, cifar_eval_transform,
                                     load_cifar)
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.serving import load_artifact
    from cnsn_tpu_torch.train.trainer import Trainer
    from cnsn_tpu_torch.utils.checkpoint import load_checkpoint
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    out_dir = os.path.join(ROOT, "chiprun_out", "trainer_wrn")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = os.path.join(out_dir, "cli.txt")
    recipe = os.path.relpath(WRN_CN_RECIPES[1], ROOT)
    cfg = load_config(WRN_CN_RECIPES[1], synthetic_data=True,
                      compute_dtype="bf16",
                      exp_dir=os.path.join(out_dir, "timed"))
    common = ["--config", WRN_CN_RECIPES[1], "--device", str(dev),
              "synthetic_data=true", "compute_dtype=bf16"]

    # (a) the command line, end to end
    exp_root = os.path.join(out_dir, "exp")
    t0 = time.perf_counter()
    with conv3x3_mode("pallas"):
        _cli(["train", *common, f"epochs={TRAINER_EPOCHS}",
              f"exp_dir={exp_root}"], log)
    train_s = time.perf_counter() - t0
    [exp_dir] = [os.path.join(d, e) for d in glob.glob(exp_root + "/*")
                 for e in os.listdir(d)]
    files = sorted(os.listdir(exp_dir))
    for want in ("log.txt", "WideResNet_last_ckpt", "WideResNet_best_ckpt",
                 "config.yaml"):
        check(want in files, f"exp dir {files} lacks {want}")
    check(any(f.startswith("code-") for f in files)
          and any(f.startswith("train-") for f in files),
          f"exp dir {files}: code snapshot, tee log")
    lines = open(os.path.join(exp_dir, "log.txt")).read().splitlines()
    header = "epoch\tlr\tTrain Loss\tTest Err1\tBest Test Err1"
    check(header in lines, f"log.txt {lines}")
    rows = [ln.split("\t") for ln in lines[lines.index(header) + 1:]]
    check(len(rows) == TRAINER_EPOCHS and all(len(r) == 5 for r in rows),
          f"log.txt rows {rows}")
    last = os.path.join(exp_dir, "WideResNet_last_ckpt")
    with conv3x3_mode("pallas"):
        printed = _cli(["eval", *common, f"resume={last}"], log)
    m = re.search(r"Test Error (\S+)", printed)
    check(m is not None and m.group(1) == rows[-1][3],
          f"cli eval printed {printed!r}, log.txt's last row {rows[-1]}")
    artifact = os.path.join(out_dir, "wrn_cnsn_bf16.pt2")
    _cli(["export", *common, f"resume={last}", "--out", artifact], log)
    model = build_classifier(cfg.model, cfg.num_classes, device=dev,
                             pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                             cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16)
    ckpt = load_checkpoint(last)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    test = load_cifar("", cfg.dataset, False, synthetic=True)
    x = torch.from_numpy(np.stack([cifar_eval_transform(im)
                                   for im in test.images[:64]])).to(dev)
    with torch.no_grad():
        eager = model(x).float()
    served = load_artifact(artifact, device=dev)(x).float()
    export_err = (served - eager).abs().max().item()
    scale = eager.abs().max().item()
    emit({"phase": "trainer_wrn_cli", "recipe": recipe,
          "epochs": TRAINER_EPOCHS, "train_s": train_s, "files": files,
          "log_rows": rows, "eval_test_error": m.group(1),
          "ckpt_epoch": ckpt["epoch"], "ckpt_step": ckpt["step"],
          "export_max_abs_err": export_err, "max_abs_logit": scale})
    check(ckpt["epoch"] == TRAINER_EPOCHS and ckpt["step"] == 4 * TRAINER_EPOCHS,
          f"checkpoint epoch {ckpt['epoch']}, step {ckpt['step']}")
    check(bool(torch.isfinite(served).all())
          and export_err <= ARTIFACT_TOL * scale,
          f"export vs eager {export_err} > {ARTIFACT_TOL} * {scale}")
    del model, served, eager

    # (b) one realistic epoch and evaluation, timed
    with conv3x3_mode("pallas"):
        trainer = Trainer(cfg, device=dev)
    b = cfg.batch_size
    train = load_cifar("", cfg.dataset, True, synthetic=True,
                       synthetic_size=TRAINER_TRAIN)
    test = load_cifar("", cfg.dataset, False, synthetic=True,
                      synthetic_size=TRAINER_TEST)
    with contextlib.redirect_stdout(open(log, "a")):
        trainer.train_epoch()  # warm-up: the 512-image set's 4 steps
        trainer.evaluate_clean()
        t0 = time.perf_counter()
        n_load = sum(1 for _ in CifarLoader(train, b, seed=cfg.seed))
        loader_ms = (time.perf_counter() - t0) * 1e3 / n_load
        trainer.train_loader = CifarLoader(train, b, seed=cfg.seed)
        trainer.test_loader = CifarLoader(test, cfg.eval_batch_size,
                                          mode="eval")
        steps = len(trainer.train_loader)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        loss = trainer.train_epoch()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        train_counts = dict(LAUNCHES)
        wait_ms = trainer.data_wait.avg * 1e3, trainer.data_wait.sum * 1e3
        LAUNCHES.clear()
        t0 = time.perf_counter()
        test_loss, test_acc = trainer.evaluate_clean()
        eval_s = time.perf_counter() - t0
        eval_counts = dict(LAUNCHES)
        # the same epoch with the loader inline (prefetch_depth 0): what
        # the staging thread saves or costs beside the main thread; then
        # one made batch fed 40 times (staging, gate and steps without the
        # loader's numpy work)
        trainer.cfg = dataclasses.replace(cfg, prefetch_depth=0)
        t0 = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        inline_s = time.perf_counter() - t0
        trainer.cfg = cfg
        made = next(iter(trainer.train_loader))
        trainer.train_loader = [made] * steps
        t0 = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        # a profile of TRAINER_PROFILE_STEPS trainer steps a call, loader
        # and staging included
        trainer.train_loader = CifarLoader(
            load_cifar("", cfg.dataset, True, synthetic=True,
                       synthetic_size=b * TRAINER_PROFILE_STEPS), b,
            seed=cfg.seed)
        prof = device_time_breakdown(trainer.train_epoch, iters=2, warmup=0,
                                     top=8)
    trainer.close()
    per_step = {}
    for k, v in cnsn_counts.items():
        check(v % TRAIN_STEPS == 0, f"train_wrn_cn cnsn.yaml {k}: {v}")
        per_step[k] = v // TRAIN_STEPS
    want_train = {k: v * steps for k, v in per_step.items()}
    batches = -(-TRAINER_TEST // cfg.eval_batch_size)
    want_eval = {K3_STAGED: WRN_SN * batches}
    step_only = b / step_ms * 1e3
    emit({"phase": "trainer_wrn", "recipe": recipe, "conv3x3": "pallas",
          "batch": b, "dtype": "bfloat16", "train_images": TRAINER_TRAIN,
          "steps": steps, "epoch_s": epoch_s,
          "train_img_per_s": steps * b / epoch_s,
          "step_only_img_per_s": step_only, "step_only_ms": step_ms,
          "trainer_ms_per_step": epoch_s * 1e3 / steps,
          "loader_host_ms_per_batch": loader_ms,
          "prefetch_wait_ms_per_step": wait_ms[0],
          "prefetch_wait_ms_total": wait_ms[1], "train_loss": loss,
          "inline_epoch_s": inline_s,
          "inline_img_per_s": steps * b / inline_s,
          "made_batch_epoch_s": made_s,
          "made_batch_img_per_s": steps * b / made_s,
          "switch_interval_s": sys.getswitchinterval(),
          "test_images": TRAINER_TEST, "eval_batch": cfg.eval_batch_size,
          "eval_s": eval_s, "eval_img_per_s": TRAINER_TEST / eval_s,
          "test_loss": test_loss, "test_acc": test_acc,
          "launches_train": train_counts, "expected_train": want_train,
          "launches_eval": eval_counts, "expected_eval": want_eval,
          "host_loadavg": os.getloadavg(), "card": nvidia_smi_name_power()})
    check(train_counts == want_train,
          f"trainer epoch launches {train_counts}, expected {want_train}")
    check(eval_counts == want_eval,
          f"trainer eval launches {eval_counts}, expected {want_eval}")
    check(math.isfinite(loss) and math.isfinite(test_loss)
          and 0.0 <= test_acc <= 1.0, f"loss {loss}, test {test_loss} "
          f"{test_acc}")
    prof["steps_per_call"] = TRAINER_PROFILE_STEPS
    prof["ms_per_step"] = prof["wall_ms"] / TRAINER_PROFILE_STEPS
    prof["kernels_per_step"] = (prof["kernels_per_call"]
                                / TRAINER_PROFILE_STEPS)
    emit({"phase": "trainer_wrn_profile", "batch": b, "dtype": "bfloat16",
          **prof})
    check(prof["launches_by_family"].get("bn_stats")
          == WRN_BN * TRAINER_PROFILE_STEPS,
          f"K2 forward kernels per trainer call "
          f"{prof['launches_by_family']}")
    del trainer
    torch.cuda.empty_cache()
    return {"train": train_counts, "eval": eval_counts, "steps": steps,
            "eval_batches": batches}


def phase_train_resnet_cn_both(dev):
    """``imagenet/resnet50/cn.yaml``: image CrossNorm at crop 'both' (the
    style statistics inside one box, applied inside another, both masked:
    plain torch) on a plain ResNet-50 (no CNSN site), b=128 224² bf16, for
    R50_CN_STEPS steps gated as the flagship is: 53 K2 launches forward
    and backward per step and no K1 launch; the time of the last three; a
    profile of one cn_image step.  Returns the launches."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    cfg, state, _, step, gates, images, _ = flagship(dev, R50_CN_RECIPE)
    check((cfg.cnsn_type, cfg.crop) == (None, "both"),
          f"resnet50/cn.yaml resolves to {cfg}")
    n = R50_CN_STEPS
    torch.cuda.synchronize()
    LAUNCHES.clear()
    per_step, losses = [], []
    for i in range(n):
        if i == 2:
            float(losses[-1])
            t0 = time.perf_counter()
        losses.append(step_launches(lambda: step(gates[i]),
                                    per_step)[1]["loss"])
    float(losses[-1])
    ms = (time.perf_counter() - t0) * 1e3 / (n - 2)
    counts = dict(LAUNCHES)
    losses = torch.stack(losses).float().cpu()
    want = {"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS}
    emit({"phase": "train_resnet_cn_both",
          "recipe": os.path.relpath(R50_CN_RECIPE, ROOT),
          "regime": cfg.regime, "crop": cfg.crop, "batch": cfg.batch_size,
          "image": IMAGE, "dtype": "bfloat16", "steps": n,
          "gates": [int(g) for g in gates[:n]], "launches": counts,
          "per_step_launches": per_step, "ms_per_step_last3": ms,
          "img_per_s": cfg.batch_size / ms * 1e3, "losses": losses.tolist(),
          "card": nvidia_smi_name_power()})
    check(all(d == want for d in per_step),
          f"resnet50/cn.yaml launches per step {per_step}, expected {want}")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
    prof = device_time_breakdown(lambda: step(True), iters=2, warmup=1,
                                 top=12)
    prof["idle_share_vs_unprofiled"] = 1.0 - prof["device_busy_ms"] / ms
    emit({"phase": "train_resnet_cn_both_profile", "step": "cn_image",
          "batch": cfg.batch_size, "dtype": "bfloat16", **prof})
    check_stats_kernels(prof, want, "resnet50/cn.yaml cn_image step")
    del state, images
    torch.cuda.empty_cache()
    return counts


def summarize(rows, name, route, source, replaces, launches, steps, n_cn,
              per="main-path training step"):
    """A kernel's line: ms, plain, bound and library time per main-path
    step, each row's time by its launches in the main-path run (mean over
    its steps)."""
    rows = [r for r in rows if r["kernel"] == name]
    runs = [r["sites"] * steps + r["cn_sites"] * n_cn for r in rows]

    def per_step(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * k for r, k in zip(rows, runs)) / steps

    heaviest = max(zip(rows, runs), key=lambda rk: rk[0]["bound_ms"] * rk[1])
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_step("kernel_ms"), "plain_ms": per_step("plain_ms"),
            "bound_ms": per_step("bound_ms"),
            "bound_by": heaviest[0]["bound_by"],
            "library_ms": per_step("library_ms"),
            "per": f"{per} (mean over {steps})"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "cnsn_tpu_torch")):
        print("chip_smoke: cnsn_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    card = nvidia_smi_name_power()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "host_cpus": os.cpu_count(), "host_loadavg": os.getloadavg()})
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    timed("build", phase_build)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    k3_rows = timed("k3_vs_plain", phase_k3_vs_plain, dev, flush)
    rows = (timed("k1_vs_plain", phase_k1_vs_plain, dev, flush)
            + timed("k2_vs_plain", phase_k2_vs_plain, dev, flush))
    k4_rows = timed("k4_vs_plain", phase_k4_vs_plain, dev, flush)
    del flush
    torch.cuda.empty_cache()
    with conv3x3_mode("conv"):
        timed("train_card_vs_cpu", phase_train_card_vs_cpu, dev)
        timed("train_card_vs_cpu_seeds", phase_train_card_vs_cpu_seeds, dev)
        train_counts, n_cn, flagship_ms = timed("train", phase_train, dev)
    flagship_k4 = timed("train_flagship_k4", phase_train_flagship_k4, dev,
                        flagship_ms, k4_rows)
    timed("wrn_k4_vs_cudnn", phase_wrn_k4_vs_cudnn, dev)
    wrn_counts = timed("train_wrn", phase_train_wrn, dev)
    with conv3x3_mode("conv"):
        timed("cn_card_vs_cpu", phase_cn_card_vs_cpu, dev)
    cn_counts, cn_ms = timed("train_wrn_cn", phase_train_wrn_cn, dev)
    trainer_counts = timed("trainer_wrn", phase_trainer_wrn, dev,
                           cn_ms["cnsn.yaml"], cn_counts["cnsn.yaml"])
    with conv3x3_mode("conv"):
        cn_counts["resnet50/cn.yaml"] = timed(
            "train_resnet_cn_both", phase_train_resnet_cn_both, dev)
    timed("model_vs_cpu", phase_model_vs_cpu, dev)
    counts = timed("serving", phase_serving, dev)

    def per_forward(batch, key, model="resnet50"):
        """K3 per bf16 forward of ``model`` at ``batch``: each shape's time
        by its sites."""
        return sum(r[key] * r["sites"] for r in k3_rows
                   if r["dtype"] == "bfloat16" and r["shape"][0] == batch
                   and r["model"] == model)

    k3_source = {"route": "cuda", "source": "cnsn_tpu_torch/csrc/selfnorm.cu",
                 "replaces": "cnsn_tpu/ops/pallas/selfnorm.py:64",
                 "bound_by": "bytes", "library_ms": None}
    k3 = {"name": K3_STAGED, **k3_source, "launches": counts[K3_STAGED],
          "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
          "ms": per_forward(BATCH, "kernel_ms"),
          "plain_ms": per_forward(BATCH, "plain_ms"),
          "bound_ms": per_forward(BATCH, "bound_ms"),
          "v1_ms": per_forward(BATCH, "v1_ms"),
          "b1": {key: per_forward(1, key) for key in
                 ("kernel_ms", "v1_ms", "plain_ms", "bound_ms")},
          "wrn_eval": {key: per_forward(128, key, "wrn") for key in
                       ("kernel_ms", "v1_ms", "plain_ms", "bound_ms")},
          "trainer_eval": {
              **{key: per_forward(EVAL_BATCH, key, "wrn_eval") for key in
                 ("kernel_ms", "v1_ms", "plain_ms", "bound_ms")},
              "launches": trainer_counts["eval"].get(K3_STAGED, 0),
              "batches": trainer_counts["eval_batches"],
              "per": f"WRN-40-2 cnsn.yaml eval batch of {EVAL_BATCH}, "
                     "bf16 (phase trainer_wrn)"},
          "per": f"b={BATCH} bf16 serving forward"}
    # The v1 kernel runs on no main path (unaligned views, C not a multiple
    # of the vector): its line holds its time at the same 16 sites through
    # the forced path
    k3_v1 = {"name": K3_V1, **k3_source, "launches": counts.get(K3_V1, 0),
             "max_abs_err": max(r["v1_max_abs_err"] for r in k3_rows),
             "ms": per_forward(BATCH, "v1_ms"),
             "plain_ms": per_forward(BATCH, "plain_ms"),
             "bound_ms": per_forward(BATCH, "bound_ms"),
             "per": f"b={BATCH} bf16 serving forward's {SN_SITES} sites, "
                    "forced path (no launch on a main path)"}
    r50 = [r for r in rows if r.get("model", "resnet50") == "resnet50"]
    kernels = [summarize(r50, name, "cuda", f"cnsn_tpu_torch/csrc/{src}",
                         replaces, train_counts[name], TRAIN_STEPS, n_cn)
               for name, src, replaces in (
                   ("ins_stats", "ins_stats.cu",
                    "cnsn_tpu/ops/pallas/ins_stats.py:140"),
                   ("ins_stats_bwd", "ins_stats.cu",
                    "cnsn_tpu/ops/pallas/ins_stats.py:179"),
                   ("bn_sums", "bn_stats.cu",
                    "cnsn_tpu/ops/pallas/bn_stats.py:109"),
                   ("bn_sums_bwd", "bn_stats.cu",
                    "cnsn_tpu/ops/pallas/bn_stats.py:146"))]
    for k in kernels:
        k["kernel"] = STATS_KERNEL[k["name"]]
    # K1's and K2's launches on the CrossNorm paths of this run (35 steps
    # of each WRN cn recipe, 5 of resnet50/cn.yaml)
    for k in kernels:
        k["cn_paths"] = {recipe: counts_.get(k["name"], 0)
                         for recipe, counts_ in cn_counts.items()}
    # K1 per step of each WRN-40-2 recipe, beside the flagship's: its
    # rows by their sites (cn.yaml: a cn step's 2 active sites of 18, mean
    # over which), its launches in this run's 35 steps of the recipe
    for k in kernels[:2]:
        k["wrn"] = {}
        for recipe, _, _ in WRN_K1_CASES:
            part = [r for r in rows if r.get("recipe") == recipe
                    and r["kernel"] == k["name"]]
            share = 2 / WRN_SN if recipe == "cn.yaml" else 1
            k["wrn"][recipe] = {
                key: (None if part[0][key] is None else
                      share * sum(r[key] * r["sites"] for r in part))
                for key in ("kernel_ms", "plain_ms", "bound_ms",
                            "library_ms")}
            k["wrn"][recipe]["launches"] = (
                wrn_counts if recipe == "sn.yaml"
                else cn_counts[recipe]).get(k["name"], 0)
            k["wrn"][recipe]["per"] = (
                "WRN-40-2 b=128 bf16 " + ("cn step" if recipe == "cn.yaml"
                                          else "training step"))
    # K2 per WRN-40-2 step, beside the flagship's
    wrn_k2 = [r for r in rows if r.get("model") == "wrn"]
    for k in kernels:
        if k["name"] in ("bn_sums", "bn_sums_bwd"):
            k["wrn"] = {key: sum(r[key] * r["sites"] for r in wrn_k2
                                 if r["kernel"] == k["name"])
                        for key in ("kernel_ms", "plain_ms", "bound_ms")}
            k["wrn"]["launches"] = wrn_counts[k["name"]]
            k["wrn"]["per"] = ("WRN-40-2 b=128 bf16 training step, "
                               "CNSN_CONV3X3=pallas")
    wrn_bf16 = [r for r in k4_rows
                if r["model"] == "wrn" and r["dtype"] == "bfloat16"]
    k4_source = "cnsn_tpu_torch/csrc/conv_wgrad.cu"
    for name, replaces in ((K4_NARROW, "cnsn_tpu/ops/pallas/conv_wgrad.py:197"),
                           (K4_WGMMA, "cnsn_tpu/ops/pallas/conv_wgrad.py:170")):
        kernels.append(summarize(
            wrn_bf16, name, "cuda", k4_source, replaces, wrn_counts[name],
            TRAIN_STEPS, 0,
            per="WRN-40-2 b=128 bf16 training step, CNSN_CONV3X3=pallas"))
        # the wmma kernel's time at the same sites, through the forced path
        kernels[-1]["wmma_ms"] = sum(
            r["wmma_ms"] * r["sites"] for r in wrn_bf16 if r["kernel"] == name)
    # The wmma kernel runs on neither main path (fp32 and unaligned calls
    # only): its line holds its time at WRN's 13 narrow sites through the
    # forced path, per WRN step, with those sites' bound, plain and cuDNN
    # times, and its fp32 rows beside.
    narrow = [r for r in wrn_bf16 if r["kernel"] == K4_NARROW]
    fp32 = [r for r in k4_rows if r["dtype"] == "float32"]
    check(wrn_counts.get(K4_WMMA, 0) == 0 and all(
        r["kernel"] == K4_WMMA for r in fp32), "K4 wmma kernel's rows")
    kernels.append({
        "name": K4_WMMA, "route": "cuda", "source": k4_source,
        "replaces": "cnsn_tpu/ops/pallas/conv_wgrad.py:197",
        "launches": wrn_counts.get(K4_WMMA, 0),
        "max_abs_err": max([r["wmma_max_abs_err"] for r in narrow]
                           + [r["max_abs_err"] for r in fp32]),
        **{out: sum(r[key] * r["sites"] for r in narrow)
           for key, out in (("wmma_ms", "ms"), ("plain_ms", "plain_ms"),
                            ("bound_ms", "bound_ms"),
                            ("library_ms", "library_ms"))},
        "bound_by": "bytes",
        "per": "WRN-40-2 b=128 bf16 training step's 13 narrow sites, "
               "forced path (no launch on a main path)",
        "fp32": [{"shape": r["shape"], "ms": r["kernel_ms"],
                  "bound_ms": r["bound_ms"], "plain_ms": r["plain_ms"],
                  "library_ms": r["library_ms"]} for r in fp32]})
    kernels[-2]["flagship"] = {
        "per": "flagship b=128 bf16 training step, CNSN_CONV3X3=pallas",
        "launches": flagship_k4["launches"],
        "steps": flagship_k4["steps"], "ms": flagship_k4["kernel_ms"],
        "wmma_ms": flagship_k4["wmma_ms"],
        "plain_ms": flagship_k4["plain_ms"],
        "bound_ms": flagship_k4["bound_ms"],
        "library_ms": flagship_k4["library_ms"]}
    # each kernel's launches in trainer_wrn's timed epoch of cnsn.yaml
    for k in kernels:
        k["trainer"] = {"launches": trainer_counts["train"].get(k["name"], 0),
                        "steps": trainer_counts["steps"],
                        "per": "WRN-40-2 cnsn.yaml Trainer epoch, b=128 "
                               "bf16, CNSN_CONV3X3=pallas"}
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "seconds_by_phase": seconds})
    emit({"kernels": [k3, k3_v1] + kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
