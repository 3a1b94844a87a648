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
  * the other three CIFAR models and the consistency regimes: K1, K2,
    K3 and K4 held against their plain versions at the shapes AllConvNet,
    DenseNet-40-12 (C ≡ 4 mod 8: one-element loads, K3's v1 kernel, K4's
    wmma kernel in bf16) and ResNeXt-29 give them, and K4 at DenseNet's
    37 3x3 sites against cuDNN's gradient and time; then
    (``train_cifar_models``) the cnsn.yaml (cn) and cnsn-consist.yaml
    (cn_consistency) recipes of AllConvNet, DenseNet-40-12 and ResNeXt-29
    and WRN-40-2's cnsn-consist.yaml at b=128 32² bf16 under
    CNSN_CONV3X3=pallas, gated, timed, every step's launches checked
    (K4 by kernel), profiled, evaluated through K3; one consistency step
    of a reduced WRN and DenseNet, card and CPU each against a float64
    twin; ``cli train``/``eval resume=`` of DenseNet's and WRN's
    cnsn-consist.yaml; 5 steps of ``imagenet/resnet50/cnsn-consist.yaml``
    (cn_image_consist) at b=128 224² bf16, its peak memory;
  * the ImageNet loaders and host AugMix: image folders and an ImageNet-C
    tree written here by PIL, the loaders timed alone ('train', 'eval',
    'train_augmix' in worker processes); ``cli train`` of
    ``imagenet/resnet50/cnsn.yaml`` on the folder and ``cli eval
    resume=`` with ``corrupt_data_dir`` (log.txt's Test Error, the mCE of
    its 75 ImageNet-C accuracies), a Trainer epoch timed beside the step
    alone; ``imagenet/resnet50_ibn_b/cnsn-augmix.yaml`` (ResNet-50-IBN-b,
    cn_image_augmix) in the step loop at its batch with its peak memory,
    then through ``cli train`` and the AugMix pool; the CIFAR
    ``cnsn-augmix.yaml`` of WRN-40-2 and DenseNet-40-12 through ``cli
    train`` and the step loop, AllConvNet's with ``no_jsd``; one float32
    ``augmix_cn`` and ``cn_image_augmix`` step each, card and CPU against
    float64 twins;
  * GTAV → Cityscapes segmentation (``cnsn_tpu/configs/segmentation/
    gtav_fcn50_cnsn.yaml``: FCN-ResNet50, SelfNorm at 'residual' and
    CrossNorm 'style' at 'post' in all 16 bottlenecks, output stride 8,
    713² crops, b=16 float32): K1, K2 and K3 held against their plain
    versions at every shape of its step and eval (read from a forward's
    hooks); 12 steps through ``SegTrainer.train_epoch`` on a synthetic
    set, the mix_prob gate opening both steps, every step's K1 and K2
    launches checked, beside each step alone, the loader alone and the
    peak memory; the recipe under compute_dtype=bfloat16 and
    ``gtav_fcn50.yaml`` (no CNSN); ``validate`` at batch 8 through K3; a
    reduced FCN-CNSN aug step, card and CPU against float64 twins; ``cli
    seg-train`` then ``seg-eval resume=`` of both recipes at 713²;
  * on-device AugMix and the normalisation options: the chain
    (``data/augmix_device.py``) on the card against the CPU at CIFAR 32²
    b=128 and ImageNet 224² b=IBN_BATCH, once under sync debug mode
    'error', ms a batch beside host AugMix's; ``cli train``/``eval`` of
    WRN-40-2's cnsn-augmix.yaml and ``cli train`` of IBN-b's with
    ondevice_augmix=true, and Trainer epochs of both on-device and with
    host AugMix, ms a step beside the step alone, launches per step;
    BatchNorm's groups, stats_sample and var_impl and SelfNorm's is_two,
    card vs CPU, K2 on the leading rows, K2's launches a WRN sn.yaml step
    under each ``CNSN_BN_*`` variable;
  * rematerialised blocks (``remat``): a gated and a plain step of the
    flagship (b=128) and of ResNet-50-IBN-b's cnsn-augmix.yaml (b=192)
    with remat against the same steps without, from the same state and
    draws (running statistics bit for bit, parameters within the spread
    of two non-remat runs, K1/K2 launches a step: each block-internal
    forward launch doubled), ms a step and peak memory on and off; IBN-b's
    recipe at its own batch_size 256 with remat=true and
    ondevice_augmix=true through ``cli train``; gtav_fcn50_cnsn.yaml at
    b=16 713² with remat=true and remat=1_2;
  * ``ckpt_backend=orbax``: ``cli train`` of WRN-40-2 cnsn.yaml in a
    subprocess, SIGTERM after two steps (exit 143, nothing left running),
    the flushed step restored and trained on, keep-2 after two epoch-end
    saves; an async save of the flagship's state; a SegTrainer's save and
    auto-restore at the recipe's shapes;
  * the NaN guard (``utils/debug.py::checked``) on a WRN-40-2 step at
    b=128: the clean step bit for bit, a NaN pixel named, its cost;
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
import copy
import dataclasses
import glob
import io
import itertools
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
# phase train_cifar_models: the cn and cn_consistency recipes of the other
# three CIFAR models and WRN-40-2's consistency recipe, b=128 32² bf16
# under CNSN_CONV3X3=pallas, timed as train_wrn times (TRAIN_STEPS)
CIFAR_RECIPES = tuple(
    os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10", model, name)
    for model in ("allconv", "densenet", "resnext")
    for name in ("cnsn.yaml", "cnsn-consist.yaml")) + (
    os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10", "wideresnet",
                 "cnsn-consist.yaml"),)
CIFAR_GATED_STEPS = 3  # the gated step timed alone, before its profile
# a forward's train-mode forwards by step kind: plain, a cn step, and a
# consistency step's clean and two CrossNorm forwards
FORWARDS = {"plain": (False,), "cn": (True,),
            "cn_consistency": (False, True, True),
            "augmix": (False,), "augmix_cn": (False, True, True)}
R50_CONSIST_RECIPE = os.path.join(ROOT, "cnsn_tpu", "configs", "imagenet",
                                  "resnet50", "cnsn-consist.yaml")
# phase kernel_vs_plain_cifar: (model, (N, H, W, C)) of K1 and K2 at
# DenseNet-40-12's C ≡ 4 (mod 8) channels (its BN and 'conv1_pre' inputs)
# and AllConvNet's late planes, b=128 bf16; K3 at DenseNet's eval batch of
# 1000; K4 (H, Cin, Cout) at DenseNet's sites (narrow 24→12, wmma from 36)
# and ResNeXt-29's stem (3→64, wmma)
CIFAR_STATS = (("densenet", (128, 32, 32, 36)),
               ("densenet", (128, 16, 16, 180)),
               ("densenet", (128, 8, 8, 324)),
               ("allconv", (128, 6, 6, 192)), ("allconv", (128, 8, 8, 192)),
               ("allconv", (128, 10, 10, 192)))
CIFAR_K3 = ((32, 36), (16, 180), (8, 324))
CIFAR_K4 = (("densenet", 32, 24, 12), ("densenet", 32, 36, 12),
            ("densenet", 8, 432, 12), ("resnext", 32, 3, 64))
# phase trainer_cifar: cli train of one synthetic epoch and cli eval
TRAINER_CIFAR_RECIPES = tuple(
    os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10", m,
                 "cnsn-consist.yaml") for m in ("densenet", "wideresnet"))

# this slice's phases: fake ImageNet folders written by PIL with a fixed
# seed (classes; train and validation JPEGs a class; their size, about
# ImageNet's mean), ImageNet-C's tree (15 corruptions × 5 severities × 2
# classes × 8 JPEGs of 224²); the IBN-b AugMix recipe's batch: its own
# b=256 (768 images a forward) does not fit an H100 80GB (out of memory
# with 78.06 GiB allocated in its first step), so the largest that does
IN_CLASSES, IN_TRAIN, IN_VAL, IN_SIZE = 10, 128, 25, (500, 375)
IN_C_CLASSES, IN_C_PER_CLASS = 2, 8
IBN_RECIPE = os.path.join(ROOT, "cnsn_tpu", "configs", "imagenet",
                          "resnet50_ibn_b", "cnsn-augmix.yaml")
IBN_BATCH = 192
CIFAR_AUGMIX_RECIPES = tuple(
    os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10", m,
                 "cnsn-augmix.yaml") for m in ("wideresnet", "densenet"))
ALLCONV_AUGMIX = os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10",
                              "allconv", "cnsn-augmix.yaml")

# the segmentation slice: gtav_fcn50_cnsn.yaml (FCN-ResNet50, SelfNorm at
# 'residual' and CrossNorm 'style' at 'post' in all 16 bottlenecks, 713²
# crops, b=16, float32: 59.9 GiB at its peak, so the recipe's batch fits)
# and gtav_fcn50.yaml (no CNSN); 55 BatchNorm2d layers (53 in the
# backbone, one in each head) and 16 SelfNorm sites; train_seg's steps
# through SegTrainer.train_epoch on a synthetic set of 729² images (the
# CLI's train_h + 16), the recipe's gate (seed 1) opening the aug step at
# step 4 of 8; the eval batch (batch_size_val) is 8
SEG_DIR = os.path.join(ROOT, "cnsn_tpu", "configs", "segmentation")
SEG_RECIPE = os.path.join(SEG_DIR, "gtav_fcn50_cnsn.yaml")
SEG_BASE_RECIPE = os.path.join(SEG_DIR, "gtav_fcn50.yaml")
SEG_BN, SEG_SN = 55, 16
SEG_STEPS, SEG_BASE_STEPS, SEG_BF16_STEPS = 8, 4, 6
SEG_VAL_IMAGES = 16
# PSPNet, PSANet and PSALite on the same recipe (arch=psp, psa, psa_lite):
# the 'psp' dilation leaves every plane's size, so PSPNet's BatchNorm2d
# inputs are the FCN's 55 and the PPM's four bins (16, 64, 144 and 576
# rows x 512 at b=16); PSANet runs at 705² (PSA_IMAGE: at 713² layer4 is
# 90², and (90 - 1) % 2 != 0 refuses its shrink factor of 2, in both
# packages; 705² gives 89², shrunk to 45², a mask of 89 x 89): 53
# backbone BNs, 5 in PSA (reduce, attention and their distribute twins,
# proj) and the two heads; PSALite (713²) 53 + 1 + 2
PSP_BN, PSA_BN, PSA_LITE_BN = SEG_BN + 4, 60, 56
PSA_IMAGE = 705
PSP_STEPS = 4  # the recipe's gate (seed 1) opens the aug step at step 4
PSP_REQUESTS = 20  # timed requests of the exported PSPNet a batch
PSP_SERVED = (1, 4)  # the batches the exported PSPNet serves

# On-device AugMix (data/augmix_device.py): the bounds of the CPU tests
# (tests/test_torch_augmix_device.py), pixel scale; its timed batches; the
# synthetic images of the timed WRN Trainer epochs (10 steps at b=128)
CIFAR_NORM = {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)}
CHAIN_PIXEL_TOL, CHAIN_FLIP_SHARE, CHAIN_TIMED = 1e-3, 1e-3, 10
ONDEVICE_CIFAR_TRAIN = 1280
# BatchNorm's options (nn/norm.py): card vs CPU at (128, 64, 16, 16), each
# error relative to the CPU's largest element: fp32 sums in other orders
# (1e-4 of the outputs and gradients, 1e-5 of the running statistics);
# bf16 outputs and input gradients round once more (2^-6, two bf16 ulps
# of the largest); stats_sample at the reference's per-replica 32 rows
BN_SAMPLE = 32
BN_OPTION_CASES = (dict(groups=2), dict(groups=4),
                   dict(stats_sample=BN_SAMPLE), dict(var_impl="two"),
                   dict(var_impl="one"))
BN_OPT_TOL = {"out": 1e-4, "running_mean": 1e-5, "running_var": 1e-5,
              "grad_x": 1e-4, "grad_weight": 1e-4, "grad_bias": 1e-4}
BN_OPT_TOL_BF16 = {"out": 2 ** -6, "grad_x": 2 ** -6}
BN_OPT_STEPS = 5


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
         phase="kernel_vs_plain", **extra):
    """One kernel_vs_plain line: the error, then times on the card.
    ``sites``: launches at this shape per training step (K3: per serving
    forward); ``cn_sites``: launches added on a cn_image step."""
    k_ms = time_ms(run, 20, flush)
    p_ms = time_ms(plain, 10, flush)
    lib_ms = time_ms(library, 10, flush) if library is not None else None
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {"phase": phase, "kernel": kernel,
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
def env_vars(**values):
    """Environment variables set for a block, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def flagship(dev, recipe=RECIPE, remat=False):
    """The flagship recipe's (or another ImageNet recipe's: cn_image or
    cn_image_consist) train state and step, b=128 224² bf16, built as a
    user builds it (``remat``: every bottleneck rematerialised);
    ``step(cn)`` runs the recipe's gated step or a plain step."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.train import (StepFns, create_train_state,
                                      imagenet_step_lr)
    cfg = load_config(recipe, compute_dtype="bf16")
    check(cfg.regime in ("cn_image", "cn_image_consist")
          and cfg.schedule == "imagenet_step",
          f"recipe resolves to {cfg.regime}, {cfg.schedule}")
    model = build_model(cfg.model, cfg.num_classes,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                        cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16,
                        remat=remat)
    state = create_train_state(
        model, imagenet_step_lr(cfg.lr, cfg.epochs, cfg.batch_size,
                                STEPS_PER_EPOCH),
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        nesterov=cfg.nesterov, device=dev)
    steps = StepFns(consist_wt=cfg.consist_wt or 0.0, image_crop=cfg.crop,
                    image_beta=cfg.beta)
    gated = getattr(steps, cfg.regime)
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
            return gated(state, images, labels, generator=perm_gen)
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
    with env_vars(CNSN_CONV3X3="pallas"):
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
        with env_vars(CNSN_CONV3X3=mode):
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
        with env_vars(CNSN_CONV3X3=mode):
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


def bound_shares(card, refs):
    """Each quantity's card error (``compare_runs``: a loss's one-step
    list, or a tensor's (error, name)) over its bound,
    ``CARD_VS_CPU_ROUNDING`` times the largest of the witnesses' errors
    ``refs``, floored at ``ROUNDING_FLOOR``."""
    return {key: got[0] / (CARD_VS_CPU_ROUNDING * max(
        max(r[key][0] for r in refs), ROUNDING_FLOOR))
        for key, got in card.items()}


def card_vs_cpu_step(dev, head, run, want, seeds=None):
    """One training step of ``train/rounding.py`` (``run(device, dtype,
    replay=, seed=, **kw)``), float32 with TF32 off, on the card and on
    the CPU, each held to a float64 twin on the CPU that replays its ReLU
    masks: the card's error at most ``CARD_VS_CPU_ROUNDING`` times the
    CPU's (``bound_shares``), in the loss and in the worst tensor of the
    state and of the momentum buffers after the step; the card's K1 and
    K2 launches equal to ``want``.  With ``seeds``, where the card reads
    within 30% of that bound the check is made again at each seed against
    the largest of two float32 witnesses (the CPU, the card with exact BN
    sums), as ``train_card_vs_cpu_seeds``.  Emits ``head`` with the
    readings."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train.rounding import compare_runs, exact_bn_sums

    def errors(device, seed=3, **kw):
        got = run(device, torch.float32, seed=seed, **kw)
        return got, compare_runs(got, run("cpu", torch.float64,
                                          replay=got.tape, seed=seed))

    torch.cuda.synchronize()
    LAUNCHES.clear()
    card, card_err = errors(dev)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    cpu, cpu_err = errors("cpu")
    share = bound_shares(card_err, [cpu_err])
    finite = all(bool(torch.isfinite(v).all())
                 for v in card.states[1].values())
    line = {"batch": 8, "image": 32, **head, "dtype": "float32",
            "tf32": False, "loss_card": card.losses[0],
            "loss_cpu": cpu.losses[0],
            "vs_replaying_float64": {"card": card_err, "cpu": cpu_err},
            "share_of_bound": share,
            "bound": f"card <= {CARD_VS_CPU_ROUNDING} x max(cpu, "
                     f"{ROUNDING_FLOOR})", "launches": launches,
            "expected_launches": want, "finite": finite}
    worst = max(share.values())
    if seeds is not None and worst > 0.7:
        line["seeds"] = {
            seed: bound_shares(errors(dev, seed)[1], [
                errors("cpu", seed)[1],
                errors(dev, seed, sums=exact_bn_sums)[1]])
            for seed in seeds}
        worst = max(max(v.values()) for v in line["seeds"].values())
    emit(line)
    what = f"{head['phase']} {head.get('knobs', head.get('model'))}"
    check(finite, f"{what}: finite parameters after the step")
    check(launches == want, f"{what}: launches {launches}, expected {want}")
    check(worst <= 1.0, f"{what}: card vs float64 at {worst} of the bound")


def phase_cn_card_vs_cpu(dev):
    """One cn step of a reduced WRN (depth 10, widen 2, pos 'post', b=8
    32²) with fixed draws (sites 1 and 3 on, each site's permutation and
    boxes from a seed: ``train/rounding.py``'s ``run_cn_step``), for
    CrossNorm 'neither' (K1 and its backward at the active sites), CNSN
    'both' (masked statistics) and CNSN 'style' (the fused site), held
    card against CPU by ``card_vs_cpu_step``."""
    from cnsn_tpu_torch.train.rounding import CN_KNOBS, CN_MASK, run_cn_step
    for knobs in CN_KNOBS:
        k1 = CN_STEP_K1[knobs]
        card_vs_cpu_step(
            dev, {"phase": "cn_card_vs_cpu", "knobs": knobs,
                  "model": "wideresnet depth 10 widen 2 pos post",
                  "mask": list(CN_MASK)},
            lambda device, dtype, **kw: run_cn_step(device, dtype, knobs,
                                                    **kw),
            {"bn_sums": CN_STEP_BN, "bn_sums_bwd": CN_STEP_BN,
             "ins_stats": k1, "ins_stats_bwd": k1})


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
        with env_vars(CNSN_CONV3X3="pallas"):
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


def cli_train_eval(common, epochs, exp_root, log):
    """``cli train`` with the arguments ``common`` under
    CNSN_CONV3X3=pallas for ``epochs`` epochs into ``exp_root``, log.txt
    holding one five-column row an epoch; then ``cli eval resume=<its last
    checkpoint>`` printing the last row's Test Error exactly.  Returns
    (exp dir, log.txt's rows, the last checkpoint, the printed Test
    Error, the seconds cli train took)."""
    t0 = time.perf_counter()
    with env_vars(CNSN_CONV3X3="pallas"):
        _cli(["train", *common, f"epochs={epochs}", f"exp_dir={exp_root}"],
             log)
    train_s = time.perf_counter() - t0
    [exp_dir] = [os.path.join(d, e) for d in glob.glob(exp_root + "/*")
                 for e in os.listdir(d)]
    lines = open(os.path.join(exp_dir, "log.txt")).read().splitlines()
    header = "epoch\tlr\tTrain Loss\tTest Err1\tBest Test Err1"
    check(header in lines, f"log.txt {lines}")
    rows = [ln.split("\t") for ln in lines[lines.index(header) + 1:]]
    check(len(rows) == epochs and all(len(r) == 5 for r in rows),
          f"log.txt rows {rows}")
    [last] = [os.path.join(exp_dir, f) for f in os.listdir(exp_dir)
              if f.endswith("_last_ckpt")]
    with env_vars(CNSN_CONV3X3="pallas"):
        printed = _cli(["eval", *common, f"resume={last}"], log)
    m = re.search(r"Test Error (\S+)", printed)
    check(m is not None and m.group(1) == rows[-1][3],
          f"cli eval printed {printed!r}, log.txt's last row {rows[-1]}")
    return exp_dir, rows, last, m.group(1), train_s


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
    exp_dir, rows, last, test_error, train_s = cli_train_eval(
        common, TRAINER_EPOCHS, os.path.join(out_dir, "exp"), log)
    files = sorted(os.listdir(exp_dir))
    for want in ("log.txt", "WideResNet_last_ckpt", "WideResNet_best_ckpt",
                 "config.yaml"):
        check(want in files, f"exp dir {files} lacks {want}")
    check(any(f.startswith("code-") for f in files)
          and any(f.startswith("train-") for f in files),
          f"exp dir {files}: code snapshot, tee log")
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
          "log_rows": rows, "eval_test_error": test_error,
          "ckpt_epoch": ckpt["epoch"], "ckpt_step": ckpt["step"],
          "export_max_abs_err": export_err, "max_abs_logit": scale})
    check(ckpt["epoch"] == TRAINER_EPOCHS and ckpt["step"] == 4 * TRAINER_EPOCHS,
          f"checkpoint epoch {ckpt['epoch']}, step {ckpt['step']}")
    check(bool(torch.isfinite(served).all())
          and export_err <= ARTIFACT_TOL * scale,
          f"export vs eager {export_err} > {ARTIFACT_TOL} * {scale}")
    del model, served, eager

    # (b) one realistic epoch and evaluation, timed
    with env_vars(CNSN_CONV3X3="pallas"):
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


def resnet_recipe_steps(dev, recipe, phase, resolves, want):
    """R50_CN_STEPS steps of an ImageNet recipe (``flagship``: b=128 224²
    bf16) gated as the flagship is, every step's launches checked against
    ``want[gate]``, the time of the last three and the peak memory; then
    one gated step alone, timed, and two profiled, their K1 and K2 kernels
    checked.  ``resolves``: the config fields the recipe must resolve to.
    Emits the ``phase`` and ``phase``_profile lines; returns the
    launches."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    cfg, state, _, step, gates, images, _ = flagship(dev, recipe)
    name = os.path.relpath(recipe, ROOT)
    got = {k: getattr(cfg, k) for k in resolves}
    check(got == resolves, f"{name} resolves to {got}")
    n = R50_CN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    t0 = time.perf_counter()
    float(step(True)[1]["loss"])
    gated_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).float().cpu()
    expected = [want[bool(g)] for g in gates[:n]]
    emit({"phase": phase, "recipe": name, "regime": cfg.regime,
          "crop": cfg.crop, "consist_wt": cfg.consist_wt,
          "batch": cfg.batch_size, "image": IMAGE, "dtype": "bfloat16",
          "steps": n, "gates": [int(g) for g in gates[:n]],
          "launches": counts, "per_step_launches": per_step,
          "ms_per_step_last3": ms, "img_per_s": cfg.batch_size / ms * 1e3,
          "gated_step_ms": gated_ms, "losses": losses.tolist(),
          "peak_mem_gib": peak, "card": nvidia_smi_name_power()})
    check(per_step == expected,
          f"{name} launches per step {per_step}, expected {expected}")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
    prof = device_time_breakdown(lambda: step(True), iters=2, warmup=0,
                                 top=12)
    prof["idle_share_vs_unprofiled"] = 1.0 - prof["device_busy_ms"] / gated_ms
    emit({"phase": phase + "_profile", "step": cfg.regime,
          "batch": cfg.batch_size, "dtype": "bfloat16", **prof})
    check_stats_kernels(prof, want[True], f"{name} {cfg.regime} step")
    del state, images
    torch.cuda.empty_cache()
    return counts


def phase_train_resnet_cn_both(dev):
    """``imagenet/resnet50/cn.yaml``: image CrossNorm at crop 'both' (the
    style statistics inside one box, applied inside another, both masked:
    plain torch) on a plain ResNet-50 (no CNSN site): 53 K2 launches
    forward and backward per step and no K1 launch
    (``resnet_recipe_steps``)."""
    step = {"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS}
    return resnet_recipe_steps(
        dev, R50_CN_RECIPE, "train_resnet_cn_both",
        {"regime": "cn_image", "cnsn_type": None, "crop": "both"},
        {False: step, True: step})


def phase_train_resnet_consist(dev):
    """``imagenet/resnet50/cnsn-consist.yaml`` (ResNet-50 + SelfNorm post,
    image CrossNorm at crop 'both' drawn twice a consistency step, three
    forwards in one graph, consist_wt 10; ``resnet_recipe_steps``): each
    forward runs 53 BatchNorms and 16 SelfNorms, and image CrossNorm at
    crop 'both' takes masked statistics (plain torch), no K1 of its own.
    Three forwards of activations stay alive to the backward: the line's
    peak memory."""
    plain = {"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS,
             "ins_stats": SN_SITES, "ins_stats_bwd": SN_SITES}
    return resnet_recipe_steps(
        dev, R50_CONSIST_RECIPE, "train_resnet_consist",
        {"regime": "cn_image_consist", "cnsn_type": "sn", "crop": "both"},
        {False: plain, True: {k: 3 * v for k, v in plain.items()}})


def phase_kernel_vs_plain_cifar(dev, flush):
    """The kernels at the shapes the three other CIFAR models give them
    (``CIFAR_STATS``, ``CIFAR_K3``, ``CIFAR_K4``), each against its plain
    version as at the other shapes, with times, bound and the library's
    call: K1 forward (eps 1e-12, SelfNorm's) and backward and K2 forward
    and backward at DenseNet's C ≡ 4 (mod 8) channels (one-element loads)
    and AllConvNet's 6², 8² and 10² planes; K3 at DenseNet's eval shapes
    at batch 1000 and at b=128 at each of its SelfNorm sites whose C is
    not a multiple of 8 (the v1 kernel); K4 bf16 at
    DenseNet's narrow and wmma sites and ResNeXt's stem.  Each row's
    ``sites`` is 1: its times are per call."""
    from cnsn_tpu_torch.ops import (bn_sums_bwd_cuda, bn_sums_bwd_reference,
                                    bn_sums_cuda, bn_sums_reference,
                                    ins_stats_bwd_cuda,
                                    ins_stats_bwd_reference, ins_stats_cuda,
                                    ins_stats_reference, selfnorm_infer_cuda,
                                    selfnorm_infer_reference, selfnorm_path,
                                    wgrad3x3_cuda, wgrad3x3_path,
                                    wgrad3x3_reference)
    from cnsn_tpu_torch.ops.kernels.conv_wgrad import PATHS
    from cnsn_tpu_torch.ops.kernels.selfnorm import PATHS as SN_PATHS
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for model, shape in CIFAR_STATS:
        n, _, _, c = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5
             + 0.3).to(torch.bfloat16)
        elems, stats = x.numel(), n * c * 4
        got, want = ins_stats_cuda(x, 1e-12), ins_stats_reference(x, 1e-12)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
        err = max((g - r).abs().max().item() for g, r in zip(got, want))
        rows.append(_row(
            "ins_stats", shape, torch.bfloat16, 1, err,
            {"rtol": 1e-5, "atol": 1e-5}, flush,
            lambda: ins_stats_cuda(x, 1e-12),
            lambda: ins_stats_reference(x, 1e-12),
            lambda: torch.std_mean(x, dim=(1, 2)), "torch.std_mean",
            elems * 2 + 2 * stats, 3 * elems, model=model, eps=1e-12))
        mean, std = want
        gm = torch.randn(n, c, generator=gen, device=dev)
        gs = torch.randn(n, c, generator=gen, device=dev)
        got = ins_stats_bwd_cuda(x, mean, std, gm, gs)
        want = ins_stats_bwd_reference(x, mean, std, gm, gs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= 2 ** -7 * want.float().abs().max().item(),
              f"K1 backward {shape}: {err}")
        rows.append(_row(
            "ins_stats_bwd", shape, torch.bfloat16, 1, err,
            {"of_max_abs": 2 ** -7}, flush,
            lambda: ins_stats_bwd_cuda(x, mean, std, gm, gs),
            lambda: ins_stats_bwd_reference(x, mean, std, gm, gs), None,
            "null: no single PyTorch call computes this backward",
            2 * elems * 2 + 4 * stats, 4 * elems, model=model))
        m0 = torch.randn(c, generator=gen, device=dev) * 0.3
        s1, s2 = bn_sums_cuda(x, m0)
        w1, w2 = bn_sums_reference(x, m0)
        torch.cuda.synchronize()
        d_abs = (x.float() - m0).abs().sum(dim=(0, 1, 2))
        err = max((s1 - w1).abs().max().item(), (s2 - w2).abs().max().item())
        check(bool(((s1 - w1).abs() <= 1e-5 * d_abs).all())
              and bool(((s2 - w2).abs() <= 1e-5 * w2).all()),
              f"K2 forward {shape}: {err}")
        rows.append(_row(
            "bn_sums", shape, torch.bfloat16, 1, err,
            {"s1_of_sum_abs": 1e-5, "s2_rtol": 1e-5}, flush,
            lambda: bn_sums_cuda(x, m0), lambda: bn_sums_reference(x, m0),
            lambda: torch.var_mean(x, dim=(0, 1, 2)), "torch.var_mean",
            elems * 2 + 3 * c * 4, 4 * elems, model=model))
        g1 = torch.randn(c, generator=gen, device=dev)
        g2 = torch.randn(c, generator=gen, device=dev) * 1e-3
        got = bn_sums_bwd_cuda(x, m0, g1, g2)
        want = bn_sums_bwd_reference(x, m0, g1, g2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= 2 ** -7 * want.float().abs().max().item(),
              f"K2 backward {shape}: {err}")
        rows.append(_row(
            "bn_sums_bwd", shape, torch.bfloat16, 1, err,
            {"of_max_abs": 2 ** -7}, flush,
            lambda: bn_sums_bwd_cuda(x, m0, g1, g2),
            lambda: bn_sums_bwd_reference(x, m0, g1, g2), None,
            "null: no single PyTorch call computes this backward",
            2 * elems * 2 + 3 * c * 4, 4 * elems, model=model))
        del x, got, want, mean, std
    # DenseNet's eval at the recipes' eval batch (one site a block), and
    # at b=128 at each SelfNorm site that takes v1 (C ≡ 4 mod 8): the
    # sites of train_cifar_models' DenseNet eval step
    recipe = os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10",
                          "densenet", "cnsn.yaml")
    sites = [(128, h, w, c) for h, w, c in selfnorm_inputs(
        _cifar_model(dev, recipe)[1].model, dev) if c % 8]
    k3_cases = ([("densenet_eval", (EVAL_BATCH, hw, hw, c))
                 for hw, c in CIFAR_K3]
                + [("densenet_eval_b128", shape) for shape in sites])
    for model, shape in k3_cases:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5
             + 0.3).to(torch.bfloat16)
        w = torch.randn(c, 2, generator=gen, device=dev) * 0.3
        a = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.1
        path = selfnorm_path(x)
        check(path == "v1", f"K3 {shape} takes {path}")
        got = selfnorm_infer_cuda(x, w, a, b)
        want = selfnorm_infer_reference(x, w, a, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16])
        err = (got.float() - want.float()).abs().max().item()
        rows.append(_row(
            SN_PATHS[path][1], shape, torch.bfloat16, 1, err,
            TOL[torch.bfloat16], flush,
            lambda: selfnorm_infer_cuda(x, w, a, b),
            lambda: selfnorm_infer_reference(x, w, a, b), None,
            "null: no single PyTorch call computes the fused SelfNorm",
            2 * x.numel() * 2 + 4 * c * 4, 5 * x.numel(), path=path,
            model=model))
        del x, got, want
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for model, hw, cin, cout in CIFAR_K4:
        x = torch.randn(128, hw, hw, cin, generator=gen,
                        device=dev).to(torch.bfloat16)
        dy = torch.randn(128, hw, hw, cout, generator=gen,
                         device=dev).to(torch.bfloat16)
        path = wgrad3x3_path(x, dy)
        got = wgrad3x3_cuda(x, dy)
        want = wgrad3x3_reference(x, dy)
        scale = wgrad3x3_reference(x.abs(), dy.abs())
        torch.cuda.synchronize()
        err = (got - want).abs()
        worst = (err / scale.clamp_min(1e-30)).max().item()
        check(bool((err <= K4_TOL * scale).all()),
              f"K4 {path} {tuple(x.shape)}->{cout}: {worst} of sum |x||dy|")
        w = torch.empty(cout, cin, 3, 3, device=dev, dtype=torch.bfloat16,
                        memory_format=torch.channels_last)
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        rows.append(_row(
            PATHS[path][1], (128, hw, hw, cin, cout), torch.bfloat16, 1,
            err.max().item(), {"of_sum_abs_x_dy": K4_TOL}, flush,
            lambda: wgrad3x3_cuda(x, dy), lambda: wgrad3x3_reference(x, dy),
            lambda: torch.ops.aten.convolution_backward(
                dyc, xc, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False]),
            "aten.convolution_backward weight only (cuDNN wgrad)",
            (x.numel() + dy.numel()) * 2 + 9 * cin * cout * 4,
            2 * x.numel() * 9 * cout, peak=BF16_FLOPS, model=model,
            err_over_sum_abs=worst, path=path))
        del x, dy, got, want, scale, err
    torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return rows


def _cifar_model(dev, recipe, **over):
    """A CIFAR recipe's config, model (bf16, CNSN_CONV3X3=pallas, random
    weights from its seed) and train state, and its steps."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
    cfg = load_config(recipe, compute_dtype="bf16", **over)
    with env_vars(CNSN_CONV3X3="pallas"):
        model = build_model(cfg.model, cfg.num_classes,
                            generator=torch.Generator().manual_seed(cfg.seed),
                            pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                            cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16)
    state = create_train_state(
        model, cosine_lr(cfg.lr, cfg.epochs * WRN_STEPS_PER_EPOCH),
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        nesterov=cfg.nesterov, device=dev)
    steps = StepFns(active_num=cfg.active_num or 1,
                    consist_wt=cfg.consist_wt or 0.0, image_crop=cfg.crop,
                    image_beta=cfg.beta)
    return cfg, state, steps


def selfnorm_inputs(model, dev, image=WRN_IMAGE):
    """(H, W, C) of the input of each SelfNorm site of ``model``, in the
    order of one eval forward."""
    from cnsn_tpu_torch.nn import SelfNorm
    shapes = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((*args[0].shape[2:],
                                         args[0].shape[1])))
        for m in model.modules() if isinstance(m, SelfNorm)]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, image, image, 3, device=dev))
    finally:
        for h in handles:
            h.remove()
        model.train()
    return shapes


def k4_paths_per_forward(model, dev, image=WRN_IMAGE):
    """K4's launches per train forward of ``model`` by kernel, from the
    path rule (``wgrad3x3_path``) at each stride-1 ``ConvCustomBwd``'s
    channels and plane in bf16 (what the backward hands K4: NHWC-
    contiguous, 16-byte-aligned copies)."""
    from cnsn_tpu_torch.models.common import ConvCustomBwd
    from cnsn_tpu_torch.ops import wgrad3x3_path
    from cnsn_tpu_torch.ops.kernels.conv_wgrad import PATHS
    paths = collections.Counter()

    def hook(module, inputs, out):
        _, cin, h, w = inputs[0].shape
        x = torch.empty(1, h, w, cin, device=dev, dtype=torch.bfloat16)
        dy = torch.empty(1, h, w, out.shape[1], device=dev,
                         dtype=torch.bfloat16)
        paths[wgrad3x3_path(x, dy)] += 1

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ConvCustomBwd) and m.stride == 1]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, image, image, 3, device=dev))
    finally:
        for h in handles:
            h.remove()
        model.train()
    return {PATHS[p][1]: n for p, n in paths.items()}


def expected_launches(model, cfg, kind, k4):
    """The K1, K2 and K4 launches of one ``kind`` step (``FORWARDS``) of a
    CNSN model at its recipe: per train forward, K2 once per BatchNorm2d
    and each way; K1 (each way) once per SelfNorm site, and on a
    CrossNorm forward once more per active CrossNorm site whose crop
    leaves a role unmasked, except at a fused CNSN site, whose one K1
    pass serves both; K4 ``k4`` per forward."""
    from cnsn_tpu_torch.nn import CNSN
    from cnsn_tpu_torch.nn.norm import BatchNorm
    sites = [m for m in model.modules() if isinstance(m, CNSN)]
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    n_sn = sum(m.selfnorm is not None for m in sites)
    fused = all(m.fused for m in sites)
    unmasked = "cn" in cfg.cnsn_type and cfg.crop != "both"
    out = collections.Counter()
    for cn in FORWARDS[kind]:
        k1 = n_sn
        if cn and not fused and unmasked:
            k1 += cfg.active_num
        out.update({"bn_sums": n_bn, "bn_sums_bwd": n_bn, "ins_stats": k1,
                    "ins_stats_bwd": k1, **k4})
    return {k: v for k, v in out.items() if v}


def phase_train_cifar_models(dev):
    """The other three CIFAR models (AllConvNet, DenseNet-40-12,
    ResNeXt-29 4×32d) at their cnsn.yaml (the cn regime) and
    cnsn-consist.yaml (cn_consistency), and WRN-40-2's cnsn-consist.yaml:
    each at b=128 32² bf16 under CNSN_CONV3X3=pallas, gated by
    ``RandomState(GATE_SEED).rand() < cn_prob`` (the gated step or plain,
    as ``cnsn_tpu/train/trainer.py:263-266`` picks), TRAIN_STEPS steps
    timed as train_wrn times them (``timed_windows``), every step's
    launches checked against ``expected_launches`` (K4 by kernel
    from the path rule at the model's shapes); the peak memory; a profile
    of one gated step (its K1 and K2 kernels checked); then one eval step
    with K3's launches by kernel against the path rule at each SelfNorm
    site.  Returns each recipe's launches and its eval launches."""
    from cnsn_tpu_torch.nn import SelfNorm
    from cnsn_tpu_torch.ops import selfnorm_path
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.ops.kernels.selfnorm import PATHS as SN_PATHS
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    out = {}
    for recipe in CIFAR_RECIPES:
        name = os.path.relpath(recipe, os.path.join(ROOT, "cnsn_tpu",
                                                     "configs"))
        cfg, state, steps = _cifar_model(dev, recipe)
        check(cfg.regime in ("cn", "cn_consistency"),
              f"{name} resolves to {cfg.regime}")
        b = cfg.batch_size
        gen = torch.Generator().manual_seed(cfg.seed)
        images = torch.randn(b, WRN_IMAGE, WRN_IMAGE, 3, generator=gen).to(dev)
        labels = torch.randint(0, cfg.num_classes, (b,),
                               generator=gen).to(dev)
        draws = torch.Generator().manual_seed(cfg.seed)
        gates = np.random.RandomState(GATE_SEED).rand(TRAIN_STEPS) < cfg.cn_prob
        gated = getattr(steps, cfg.regime)

        def step(cn):
            if cn:
                return gated(state, images, labels, generator=draws)
            return steps.plain(state, images, labels)

        k4 = k4_paths_per_forward(state.model, dev)
        want = {kind: expected_launches(state.model, cfg, kind, k4)
                for kind in ("plain", cfg.regime)}
        torch.cuda.synchronize()
        LAUNCHES.clear()
        per_step, losses, window_ms, warmup_s = timed_windows(
            lambda i: step(gates[i]))
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(window_ms)
        emit({"phase": "train_cifar_models", "recipe": name,
              "model": cfg.model, "regime": cfg.regime, "pos": cfg.pos,
              "cnsn_type": cfg.cnsn_type, "crop": cfg.crop,
              "cn_prob": cfg.cn_prob, "active_num": cfg.active_num,
              "consist_wt": cfg.consist_wt, "conv3x3": "pallas", "batch": b,
              "image": WRN_IMAGE, "dtype": "bfloat16", "steps": TRAIN_STEPS,
              "gated_steps": int(gates.sum()),
              "gates": [int(g) for g in gates],
              "k4_per_forward_by_kernel": k4,
              "expected_per_step": want, "launches": counts,
              "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
              "losses_finite": bool(torch.isfinite(losses).all()),
              "warmup_s": warmup_s, "windows_ms_per_step": window_ms,
              "ms_per_step": med, "img_per_s": b / med * 1e3,
              "peak_mem_gib": peak, "host_loadavg": os.getloadavg(),
              "card": nvidia_smi_name_power()})
        bad = [(i, got, want[cfg.regime if g else "plain"])
               for i, (got, g) in enumerate(zip(per_step, gates))
               if got != want[cfg.regime if g else "plain"]]
        check(not bad, f"{name} launches per step (step, got, expected): "
              f"{bad[:2]}")
        check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
        # the gated step alone (the windows mix it with plain steps), then
        # one of it profiled, beside that time
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(CIFAR_GATED_STEPS):
            loss = step(True)[1]["loss"]
        float(loss)
        gated_ms = (time.perf_counter() - t0) * 1e3 / CIFAR_GATED_STEPS
        prof = device_time_breakdown(lambda: step(True), iters=1, warmup=0,
                                     top=12)
        prof["gated_step_ms_unprofiled"] = gated_ms
        prof["idle_share_vs_unprofiled"] = (1.0 - prof["device_busy_ms"]
                                            / gated_ms)
        prof["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        emit({"phase": "train_cifar_models_profile", "recipe": name,
              "step": cfg.regime, "batch": b, "dtype": "bfloat16", **prof})
        check_stats_kernels(prof, want[cfg.regime], f"{name} gated step")
        paths = collections.Counter()
        handles = [m.register_forward_pre_hook(
            lambda mod, args: paths.update(
                [SN_PATHS[selfnorm_path(args[0].permute(0, 2, 3, 1))][1]]))
            for m in state.model.modules() if isinstance(m, SelfNorm)]
        LAUNCHES.clear()
        ev = steps.eval_step(state, images, labels)
        torch.cuda.synchronize()
        for h in handles:
            h.remove()
        k3 = dict(LAUNCHES)
        emit({"phase": "train_cifar_models_then_eval", "recipe": name,
              "batch": b, "launches": k3, "expected": dict(paths),
              "loss": ev["loss"].item(), "correct": ev["correct"].item()})
        check(k3 == dict(paths) and sum(k3.values()) == sum(
            isinstance(m, SelfNorm) for m in state.model.modules()),
            f"{name} eval launches {k3}, expected {dict(paths)}")
        check(ev["logits"].shape == (b, cfg.num_classes)
              and bool(torch.isfinite(ev["logits"]).all()),
              f"finite {name} eval logits")
        out[name] = {"train": counts, "eval": k3, "steps": TRAIN_STEPS,
                     "ms_per_step": med}
        del state, images, ev
        torch.cuda.empty_cache()
    return out


def phase_densenet_k4_vs_cudnn(dev, flush):
    """DenseNet-40-12 (cnsn.yaml, b=128 32² bf16, CNSN_CONV3X3=pallas):
    one train forward and backward, the x and dy of each of its 37
    stride-1 3×3 convs captured; at each, K4's weight gradient (the
    kernel the path rule picks: wmma from Cin 36 on, narrow at 3→24 and
    24→12) against cuDNN's float32 gradient of the same bf16 values (TF32
    off), within K4_TOL of Σ|x|·|dy|; the gradient the backward handed the
    conv weight equal to K4's rounded to bf16; and per site K4's time
    beside cuDNN's bf16 weight gradient (what the conv mode runs) and the
    plain version, with its bound.  Returns per-step sums by kernel."""
    from cnsn_tpu_torch.models.common import ConvCustomBwd
    from cnsn_tpu_torch.ops import (wgrad3x3_cuda, wgrad3x3_path,
                                    wgrad3x3_reference)
    from cnsn_tpu_torch.train.losses import cross_entropy
    recipe = os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10",
                          "densenet", "cnsn.yaml")
    cfg, state, _ = _cifar_model(dev, recipe)
    model = state.model
    gen = torch.Generator().manual_seed(cfg.seed)
    images = torch.randn(cfg.batch_size, WRN_IMAGE, WRN_IMAGE, 3,
                         generator=gen).to(dev)
    labels = torch.randint(0, cfg.num_classes, (cfg.batch_size,),
                           generator=gen).to(dev)
    convs = {n: m for n, m in model.named_modules()
             if isinstance(m, ConvCustomBwd) and m.stride == 1}
    seen = {}

    def hook(name):
        def fn(module, inputs, out):
            # the conv's input in its compute type (the stem's is cast)
            seen[name] = [inputs[0].detach().to(out.dtype), None]
            out.register_hook(lambda g: seen[name].__setitem__(1, g))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in convs.items()]
    model.zero_grad(set_to_none=True)
    cross_entropy(model.train()(images), labels).backward()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    sites, totals = [], collections.defaultdict(float)
    for name, conv in convs.items():
        xc, dyc = seen[name]
        x = xc.permute(0, 2, 3, 1).contiguous()
        dy = dyc.permute(0, 2, 3, 1).contiguous()
        cin, cout = x.shape[-1], dy.shape[-1]
        path = wgrad3x3_path(x, dy)
        got = wgrad3x3_cuda(x, dy).permute(3, 2, 0, 1)
        w32 = torch.empty(cout, cin, 3, 3, device=dev)
        ref = torch.ops.aten.convolution_backward(
            dyc.float(), xc.float(), w32, None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [False, True, False])[1]
        scale = wgrad3x3_reference(x.abs(), dy.abs()).permute(3, 2, 0, 1)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        worst = (err / scale.clamp_min(1e-30)).max().item()
        applied = torch.equal(conv.weight.grad,
                              got.to(torch.bfloat16).float())
        check(bool((err <= K4_TOL * scale).all()),
              f"DenseNet {name} K4 {path} vs cuDNN: {worst} of sum |x||dy|")
        check(applied, f"DenseNet {name}: the weight's gradient is not K4's")
        wb = torch.empty(cout, cin, 3, 3, device=dev, dtype=torch.bfloat16,
                         memory_format=torch.channels_last)
        k_ms = time_ms(lambda: wgrad3x3_cuda(x, dy), 20, flush)
        lib_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
            dyc, xc, wb, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False]), 20, flush)
        p_ms = time_ms(lambda: wgrad3x3_reference(x, dy), 5, flush)
        b_ms, b_by = bound((x.numel() + dy.numel()) * 2 + 9 * cin * cout * 4,
                           2 * x.numel() * 9 * cout, BF16_FLOPS)
        sites.append({"conv": name, "shape": list(x.shape), "cout": cout,
                      "path": path, "err_over_sum_abs": worst,
                      "kernel_ms": k_ms, "cudnn_ms": lib_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
        for key, v in (("kernel_ms", k_ms), ("library_ms", lib_ms),
                       ("plain_ms", p_ms), ("bound_ms", b_ms)):
            totals[(path, key)] += v
        totals[(path, "sites")] += 1
        del x, dy, got, ref, scale, err
    torch.backends.cudnn.allow_tf32 = tf32
    by_path = collections.defaultdict(dict)
    for (path, key), v in totals.items():
        by_path[path][key] = v
    emit({"phase": "densenet_k4_vs_cudnn", "recipe": "cifar10/densenet/"
          "cnsn.yaml", "batch": cfg.batch_size, "image": WRN_IMAGE,
          "dtype": "bfloat16", "tol": f"{K4_TOL} of sum |x||dy| against "
          "cuDNN's float32 gradient of the same bf16 values",
          "sites": sites, "per_step_by_kernel": dict(by_path),
          "card": nvidia_smi_name_power()})
    del state, model, seen
    torch.cuda.empty_cache()
    return dict(by_path)


def phase_consist_card_vs_cpu(dev):
    """One cn_consistency step (three forwards, fixed masks and draws:
    ``train/rounding.py::run_consist_step``) of a WRN of depth 10 at
    cnsn-consist.yaml's knobs and of a DenseNet of depth 7 at its
    cnsn-consist.yaml's (crop 'content': C = 24, 36, 48), b=8 32², held
    card against CPU by ``card_vs_cpu_step``, with the multi-seed witness
    check at seeds 0-3 where one seed reads within 30% of the bound."""
    from cnsn_tpu_torch.train.rounding import CONSIST, run_consist_step
    bn = {"wrn": CN_STEP_BN, "densenet": 6}
    k1 = {"wrn": 3 * 3, "densenet": 3 * 3 + 1 + 1}  # 3 SN sites, content crop
    for model in CONSIST:
        card_vs_cpu_step(
            dev, {"phase": "consist_card_vs_cpu", "model": model},
            lambda device, dtype, **kw: run_consist_step(device, dtype,
                                                         model, **kw),
            {"bn_sums": 3 * bn[model], "bn_sums_bwd": 3 * bn[model],
             "ins_stats": k1[model], "ins_stats_bwd": k1[model]},
            seeds=range(4))


def phase_trainer_cifar(dev):
    """``cli train`` of cifar10/densenet/cnsn-consist.yaml and of
    cifar10/wideresnet/cnsn-consist.yaml (cn_consistency), bf16, one
    epoch of the synthetic set (512 images: 4 steps at b=128, then an
    evaluation of its 512 test images), then ``cli eval resume=<last>``
    (``cli_train_eval``).  The printing goes to
    chiprun_out/trainer_cifar/cli.txt, the experiment directories
    (checkpoints) to a temporary directory."""
    out_dir = os.path.join(ROOT, "chiprun_out", "trainer_cifar")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = os.path.join(out_dir, "cli.txt")
    with tempfile.TemporaryDirectory() as tmp:
        for recipe in TRAINER_CIFAR_RECIPES:
            model = os.path.basename(os.path.dirname(recipe))
            _, rows, last, test_error, train_s = cli_train_eval(
                ["--config", recipe, "--device", str(dev),
                 "synthetic_data=true", "compute_dtype=bf16"], 1,
                os.path.join(tmp, model), log)
            emit({"phase": "trainer_cifar",
                  "recipe": os.path.relpath(recipe, ROOT), "epochs": 1,
                  "train_s": train_s, "log_rows": rows,
                  "eval_test_error": test_error,
                  "checkpoint": os.path.basename(last)})
            check(math.isfinite(float(rows[-1][2])), f"train loss {rows[-1]}")
    torch.cuda.empty_cache()


def _jpeg(path, seed, size, quality=90):
    """One JPEG of smooth content (random coarse colours, upsampled) from
    ``seed``, (width, height) ``size``."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    w, h = size
    coarse = rng.randint(0, 256, (h // 24 + 2, w // 24 + 2, 3), np.uint8)
    Image.fromarray(coarse).resize((w, h), Image.BICUBIC).save(
        path, quality=quality)
    return os.path.getsize(path)


def write_fake_imagenet(root):
    """ImageNet's layout under ``root`` (train/ and validation/, a folder
    a class) and ImageNet-C's under ``root``/c (corruption/severity/
    class), written by PIL with a fixed seed in threads.  Returns (data
    dir, ImageNet-C dir, {tree: (files, bytes)})."""
    from cnsn_tpu_torch.evaluation.classify import CORRUPTIONS
    jobs = []
    for split, n in (("train", IN_TRAIN), ("validation", IN_VAL)):
        for c in range(IN_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            jobs += [(split, os.path.join(d, f"{i:04d}.JPEG"), IN_SIZE)
                     for i in range(n)]
    for corruption in CORRUPTIONS:
        for sev in range(1, 6):
            for c in range(IN_C_CLASSES):
                d = os.path.join(root, "c", corruption, str(sev), f"n{c:08d}")
                os.makedirs(d)
                jobs += [("imagenet_c", os.path.join(d, f"{i}.JPEG"),
                          (IMAGE, IMAGE)) for i in range(IN_C_PER_CLASS)]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        sizes = list(pool.map(lambda j: _jpeg(j[1][1], j[0], j[1][2]),
                              enumerate(jobs)))
    trees = collections.defaultdict(lambda: [0, 0])
    for (tree, _, _), nbytes in zip(jobs, sizes):
        trees[tree][0] += 1
        trees[tree][1] += nbytes
    return root, os.path.join(root, "c"), dict(trees)


def time_loader(loader):
    """One pass of ``loader``: ms for each batch (the first includes the
    pool's start-up and the first look-ahead), its shapes checked
    finite."""
    ms, shapes = [], set()
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        try:
            images, labels = next(it)
        except StopIteration:
            break
        ms.append((time.perf_counter() - t0) * 1e3)
        shapes.add(images.shape)
        check(images.dtype == np.float32 and np.isfinite(images).all()
              and labels.dtype == np.int32, f"batch {images.shape}")
    return ms, sorted(shapes)


def phase_imagenet_loader(root):
    """The ImageNet host loaders alone on a PIL-written folder
    (``write_fake_imagenet``): 'train' at b=128 (the recipes' batch) with
    the recipes' 4 decode threads and with one a core, 'eval' at the
    recipes' eval batch, 'train_augmix' at b=256 (the IBN-b recipe's)
    with os.cpu_count() − 1 worker processes.  Returns the paths and ms
    per batch."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.data import ImageNetLoader, scan_image_folder
    t0 = time.perf_counter()
    data_dir, corrupt_dir, trees = write_fake_imagenet(root)
    write_s = time.perf_counter() - t0
    cfg = load_config(RECIPE)
    train = scan_image_folder(os.path.join(data_dir, "train"))
    val = scan_image_folder(os.path.join(data_dir, "validation"))
    check(len(train.samples) == IN_CLASSES * IN_TRAIN
          and len(val.classes) == IN_CLASSES, "the fake folders")
    ncpu = os.cpu_count()
    out = {}
    for name, loader in (
            (f"train_b{cfg.batch_size}_threads{cfg.workers}",
             ImageNetLoader(train, cfg.batch_size, workers=cfg.workers)),
            (f"train_b{cfg.batch_size}_threads{ncpu}",
             ImageNetLoader(train, cfg.batch_size, workers=ncpu)),
            (f"eval_b{cfg.eval_batch_size}_threads{cfg.workers}",
             ImageNetLoader(val, cfg.eval_batch_size, mode="eval",
                            workers=cfg.workers))):
        ms, shapes = time_loader(loader)
        out[name] = {"ms_per_batch": ms, "shapes": shapes,
                     "ms_per_batch_mean": statistics.mean(ms)}
    with ImageNetLoader(train, IBN_BATCH, mode="train_augmix",
                        mp_workers=ncpu - 1) as augmix_loader:
        ms, shapes = time_loader(augmix_loader)
    out[f"train_augmix_b{IBN_BATCH}_procs{ncpu - 1}"] = {
        "ms_per_batch": ms, "shapes": shapes,
        "ms_per_batch_mean_after_first": statistics.mean(ms[1:])}
    check(shapes == [(3, IBN_BATCH, IMAGE, IMAGE, 3)], f"AugMix {shapes}")
    emit({"phase": "imagenet_loader", "trees_files_bytes": trees,
          "jpeg_size": IN_SIZE, "write_s": write_s, "host_cpus": ncpu,
          "loaders": out, "host_loadavg": os.getloadavg(),
          "card": nvidia_smi_name_power()})
    return data_dir, corrupt_dir, out


class StepCounts:
    """The launches of each step a Trainer takes, and the host's clock at
    its call: its step functions wrapped (``step_launches``) where the
    Trainer calls them, not where one step calls another (cn_image ends
    in plain)."""

    def __init__(self, trainer, names):
        self.per_step, self.names, self.times, depth = [], [], [], [0]
        for name in names:
            fn = getattr(trainer.steps, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                if depth[0]:
                    return _fn(*a, **kw)
                depth[0] += 1
                try:
                    self.times.append(time.perf_counter())
                    self.names.append(_name)
                    return step_launches(lambda: _fn(*a, **kw),
                                         self.per_step)
                finally:
                    depth[0] -= 1
            setattr(trainer.steps, name, wrapped)


def _spy_evaluate(accs):
    """``train/trainer.py``'s ``evaluate``, each result's accuracy
    appended to ``accs``; restore with the returned function."""
    import cnsn_tpu_torch.train.trainer as trainer_mod
    evaluate = trainer_mod.evaluate

    def spy(*a, **kw):
        out = evaluate(*a, **kw)
        accs.append(out[1])
        return out
    trainer_mod.evaluate = spy

    def restore():
        trainer_mod.evaluate = evaluate
    return restore


def phase_trainer_imagenet(dev, data_dir, corrupt_dir, step_ms, loader_ms):
    """The flagship recipe through the port's entry points on the fake
    folder, bf16: ``cli train`` one epoch (10 steps at b=128, then an
    evaluation of the 250 validation images), its launches against the
    count from the code (K2 53 and K1 16 each way a step, K1 one more on
    a cn_image step; K3 16 an eval forward); ``cli eval resume=<last>
    corrupt_data_dir=`` printing log.txt's Test Error exactly and an mCE
    equal to ``compute_mce`` of its 75 ImageNet-C accuracies; then a
    ``Trainer`` of the same recipe, one epoch timed (ms per step beside
    phase train's step-only ms and the loader's ms per batch alone), the
    wait per staged batch, each step's launches checked."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.evaluation.classify import compute_mce
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train.trainer import Trainer
    out_dir = os.path.join(ROOT, "chiprun_out", "trainer_imagenet")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = os.path.join(out_dir, "cli.txt")
    over = [f"data_dir={data_dir}", "compute_dtype=bf16"]
    common = ["--config", RECIPE, "--device", str(dev), *over]
    cfg = load_config(RECIPE, data_dir=data_dir, compute_dtype="bf16")
    steps = IN_CLASSES * IN_TRAIN // cfg.batch_size
    gates = np.random.RandomState(cfg.seed).rand(steps) < cfg.cn_prob
    eval_forwards = -(-IN_CLASSES * IN_VAL // cfg.eval_batch_size)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with env_vars(CNSN_CONV3X3="conv"):
            _cli(["train", *common, "epochs=1", f"exp_dir={tmp}/exp"], log)
        train_s = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        want = {"bn_sums": BN_LAYERS * steps, "bn_sums_bwd": BN_LAYERS * steps,
                "ins_stats": SN_SITES * steps + int(gates.sum()),
                "ins_stats_bwd": SN_SITES * steps,
                K3_STAGED: SN_SITES * eval_forwards}
        check(counts == want, f"cli train launches {counts}, expected {want}")
        [exp_dir] = glob.glob(f"{tmp}/exp/*/*")
        rows = open(os.path.join(exp_dir, "log.txt")).read().splitlines()
        row = rows[-1].split("\t")
        check(len(row) == 5 and math.isfinite(float(row[2])),
              f"log.txt {rows}")
        accs = []
        restore = _spy_evaluate(accs)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        try:
            with env_vars(CNSN_CONV3X3="conv"):
                printed = _cli(["eval", *common,
                                f"resume={exp_dir}/ResNet_last_ckpt",
                                f"corrupt_data_dir={corrupt_dir}"], log)
        finally:
            restore()
        eval_s = time.perf_counter() - t0
        eval_counts = dict(LAUNCHES)
    m = re.search(r"Test Error (\S+)", printed)
    check(m is not None and m.group(1) == row[3],
          f"cli eval printed {printed[:200]!r}, log.txt's row {row}")
    from cnsn_tpu_torch.evaluation.classify import CORRUPTIONS
    check(len(accs) == 76, f"{len(accs)} evaluations, expected 1 + 75")
    mce, _ = compute_mce({c: accs[1 + 5 * k:6 + 5 * k]
                          for k, c in enumerate(CORRUPTIONS)})
    printed_mce = re.search(r"^mCE: (\S+)$", printed, re.M)
    check(printed_mce is not None and printed_mce.group(1) == f"{mce:.2f}",
          f"printed mCE {printed_mce}, compute_mce {mce}")
    # ImageNet-C's folders, one eval batch each, and the clean set's
    c_forwards = 75 * -(-IN_C_CLASSES * IN_C_PER_CLASS
                        // cfg.eval_batch_size)
    check(eval_counts == {K3_STAGED: SN_SITES * (eval_forwards + c_forwards)},
          f"cli eval launches {eval_counts}")
    # the Trainer alone: one epoch timed, each step's launches
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(RECIPE, data_dir=data_dir, compute_dtype="bf16",
                          snapshot=False, exp_dir=tmp, print_freq=1000)
        with env_vars(CNSN_CONV3X3="conv"):
            trainer = Trainer(cfg, device=dev)
        try:
            rec = StepCounts(trainer, ("cn_image", "plain"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_epoch()
            torch.cuda.synchronize()
            epoch_ms = (time.perf_counter() - t0) * 1e3
            wait_ms = trainer.data_wait.avg * 1e3
        finally:
            trainer.close()
    plain = {"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS,
             "ins_stats": SN_SITES, "ins_stats_bwd": SN_SITES}
    expected = [dict(plain, ins_stats=SN_SITES + (name == "cn_image"))
                for name in rec.names]
    check(rec.per_step == expected and len(expected) == steps,
          f"Trainer launches per step {rec.per_step}")
    check(rec.names == ["cn_image" if g else "plain" for g in gates],
          f"Trainer steps {rec.names}")
    emit({"phase": "trainer_imagenet", "recipe": os.path.relpath(RECIPE, ROOT),
          "dtype": "bfloat16", "batch": cfg.batch_size, "steps": steps,
          "cn_image_steps": int(gates.sum()), "cli_train_s": train_s,
          "cli_train_launches": counts, "log_row": row,
          "eval_test_error": m.group(1), "cli_eval_s": eval_s,
          "cli_eval_launches": eval_counts, "mce": mce,
          "imagenet_c_accs": accs[1:], "trainer_epoch_ms": epoch_ms,
          "trainer_ms_per_step": epoch_ms / steps,
          "step_only_ms": step_ms, "trainer_over_step_only":
              step_ms / (epoch_ms / steps),
          "data_wait_ms_per_batch": wait_ms,
          "loader_alone_ms_per_batch": loader_ms,
          "trainer_loss": loss, "host_cpus": os.cpu_count(),
          "host_loadavg": os.getloadavg(), "card": nvidia_smi_name_power()})
    torch.cuda.empty_cache()
    return counts


def phase_train_resnet_ibn_augmix(dev, data_dir):
    """``imagenet/resnet50_ibn_b/cnsn-augmix.yaml`` (ResNet-50-IBN-b, SN
    at pos 'residual': 16 sites, an InstanceNorm stem, so 52 BatchNorms;
    cn_image_augmix gated at cn_prob 0.5, else augmix) at b=IBN_BATCH
    224² bf16: TRAIN_STEPS steps of the step loop on pre-made (3, B)
    views from seeds, timed as train_wrn (``timed_windows``), each step's
    launches against the count (K2 52, K1 16 each way, K1 one more on the
    gated step: the image statistics of the 3B batch), the peak memory;
    an eval step through K3 (16); then ``cli train`` of one epoch of 2
    steps through the host AugMix pool (os.cpu_count() − 1 processes) on
    the first 2·B images of the fake folder."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.nn import SelfNorm
    from cnsn_tpu_torch.nn.norm import BatchNorm
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train import (StepFns, create_train_state,
                                      imagenet_step_lr)
    cfg = load_config(IBN_RECIPE, compute_dtype="bf16")
    check((cfg.regime, cfg.pos, cfg.cnsn_type, cfg.crop, cfg.model)
          == ("cn_image_augmix", "residual", "sn", "neither",
              "resnet50_ibn_b"), f"{IBN_RECIPE} resolves to {cfg.regime}")
    b = IBN_BATCH
    with env_vars(CNSN_CONV3X3="conv"):
        model = build_model(cfg.model, cfg.num_classes,
                            generator=torch.Generator().manual_seed(cfg.seed),
                            pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                            cnsn_type=cfg.cnsn_type, dtype=torch.bfloat16)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    n_sn = sum(isinstance(m, SelfNorm) for m in model.modules())
    check((n_bn, n_sn) == (BN_LAYERS - 1, SN_SITES),
          f"IBN-b has {n_bn} BatchNorms and {n_sn} SelfNorms")
    state = create_train_state(
        model, imagenet_step_lr(cfg.lr, cfg.epochs, cfg.batch_size,
                                STEPS_PER_EPOCH),
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        nesterov=cfg.nesterov, device=dev)
    steps = StepFns(image_crop=cfg.crop, image_beta=cfg.beta)
    gen = torch.Generator().manual_seed(cfg.seed)
    images3 = torch.randn(3, b, IMAGE, IMAGE, 3, generator=gen).to(dev)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen).to(dev)
    perm_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    gates = np.random.RandomState(GATE_SEED).rand(TRAIN_STEPS) < cfg.cn_prob

    def step(i):
        if gates[i]:
            return steps.cn_image_augmix(state, images3, labels,
                                         generator=perm_gen)
        return steps.augmix(state, images3, labels)

    plain = {"bn_sums": n_bn, "bn_sums_bwd": n_bn, "ins_stats": n_sn,
             "ins_stats_bwd": n_sn}
    want = {False: plain, True: dict(plain, ins_stats=n_sn + 1)}
    torch.cuda.synchronize()
    LAUNCHES.clear()
    per_step, losses, window_ms, warmup_s = timed_windows(step)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(window_ms)
    expected = [want[bool(g)] for g in gates]
    LAUNCHES.clear()
    ev = steps.eval_step(state, images3[0], labels)
    torch.cuda.synchronize()
    k3 = dict(LAUNCHES)
    emit({"phase": "train_resnet_ibn_augmix",
          "recipe": os.path.relpath(IBN_RECIPE, ROOT), "regime": cfg.regime,
          "batch": b, "recipe_batch": cfg.batch_size, "views": 3,
          "image": IMAGE, "dtype": "bfloat16", "steps": TRAIN_STEPS,
          "gated_steps": int(gates.sum()), "gates": [int(g) for g in gates],
          "launches": counts, "expected_per_step": {
              "augmix": want[False], "cn_image_augmix": want[True]},
          "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
          "warmup_s": warmup_s, "windows_ms_per_step": window_ms,
          "ms_per_step": med, "img_per_s": b / med * 1e3,
          "peak_mem_gib": peak, "eval_launches": k3,
          "host_loadavg": os.getloadavg(), "card": nvidia_smi_name_power()})
    bad = [(i, got, w) for i, (got, w) in enumerate(zip(per_step, expected))
           if got != w]
    check(not bad, f"IBN-b launches per step (step, got, expected): "
          f"{bad[:2]}")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
    check(k3 == {K3_STAGED: n_sn}, f"IBN-b eval launches {k3}")
    check(bool(torch.isfinite(ev["logits"]).all()), "finite IBN-b logits")
    del state, images3, ev
    torch.cuda.empty_cache()
    # cli train through the host AugMix pool: 2 steps
    out_dir = os.path.join(ROOT, "chiprun_out", "train_resnet_ibn_augmix")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with tempfile.TemporaryDirectory() as tmp:
        small = os.path.join(tmp, "data")
        files = sorted(glob.glob(os.path.join(data_dir, "train", "*", "*")))
        for f in files[:2 * b]:
            d = os.path.join(small, "train", os.path.basename(
                os.path.dirname(f)))
            os.makedirs(d, exist_ok=True)
            os.symlink(f, os.path.join(d, os.path.basename(f)))
        os.symlink(os.path.join(data_dir, "validation"),
                   os.path.join(small, "validation"))
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with env_vars(CNSN_CONV3X3="conv"):
            _cli(["train", "--config", IBN_RECIPE, "--device", str(dev),
                  f"data_dir={small}", "compute_dtype=bf16", "epochs=1",
                  f"batch_size={b}", f"augmix_workers={os.cpu_count() - 1}",
                  f"exp_dir={tmp}/exp"],
                 os.path.join(out_dir, "cli.txt"))
        cli_s = time.perf_counter() - t0
        cli_counts = dict(LAUNCHES)
        [exp_dir] = glob.glob(f"{tmp}/exp/*/*")
        row = open(os.path.join(exp_dir, "log.txt")).read().splitlines()[-1]
    cli_gates = np.random.RandomState(cfg.seed).rand(2) < cfg.cn_prob
    check(cli_counts.get("bn_sums") == 2 * n_bn
          and cli_counts.get("ins_stats") == 2 * n_sn + int(cli_gates.sum())
          and cli_counts.get(K3_STAGED) == n_sn,
          f"IBN-b cli train launches {cli_counts}")
    check(math.isfinite(float(row.split("\t")[2])), f"log.txt row {row}")
    emit({"phase": "train_resnet_ibn_augmix_cli", "batch": b, "steps": 2,
          "augmix_workers": os.cpu_count() - 1, "cli_train_s": cli_s,
          "launches": cli_counts, "log_row": row})
    torch.cuda.empty_cache()
    return counts, peak, med


def phase_train_cifar_augmix(dev):
    """The CIFAR AugMix recipes (cnsn-augmix.yaml: cn_augmix, augmix_cn
    gated at cn_prob 0.75 else augmix) of WRN-40-2 and DenseNet-40-12:
    ``cli train`` of one synthetic epoch (4 steps at b=128, the host
    AugMix in 4 worker processes) and ``cli eval resume=``
    (``cli_train_eval``, CNSN_CONV3X3=pallas); then TRAIN_STEPS steps of
    the step loop on pre-made (3, 128) views, timed, each step's launches
    against ``expected_launches`` (a 3B forward, and two B forwards with
    CrossNorm on a gated step); then one ``no_jsd=true`` epoch of
    AllConvNet's (one AugMix view, the cn and plain steps)."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    out_dir = os.path.join(ROOT, "chiprun_out", "train_cifar_augmix")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = os.path.join(out_dir, "cli.txt")
    out, step_ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for recipe in CIFAR_AUGMIX_RECIPES:
            model = os.path.basename(os.path.dirname(recipe))
            _, rows, _, test_error, train_s = cli_train_eval(
                ["--config", recipe, "--device", str(dev),
                 "synthetic_data=true", "compute_dtype=bf16",
                 "augmix_workers=4"], 1, os.path.join(tmp, model), log)
            check(math.isfinite(float(rows[-1][2])), f"train loss {rows}")
            cfg, state, steps = _cifar_model(dev, recipe)
            check(cfg.regime == "cn_augmix", f"{recipe}: {cfg.regime}")
            b = cfg.batch_size
            gen = torch.Generator().manual_seed(cfg.seed)
            images3 = torch.randn(3, b, WRN_IMAGE, WRN_IMAGE, 3,
                                  generator=gen).to(dev)
            labels = torch.randint(0, cfg.num_classes, (b,),
                                   generator=gen).to(dev)
            draws = torch.Generator().manual_seed(cfg.seed)
            gates = (np.random.RandomState(GATE_SEED).rand(TRAIN_STEPS)
                     < cfg.cn_prob)

            def step(i):
                if gates[i]:
                    return steps.augmix_cn(state, images3, labels,
                                           generator=draws)
                return steps.augmix(state, images3, labels)

            k4 = k4_paths_per_forward(state.model, dev)
            want = {kind: expected_launches(state.model, cfg, kind, k4)
                    for kind in ("augmix", "augmix_cn")}
            torch.cuda.synchronize()
            LAUNCHES.clear()
            per_step, losses, window_ms, warmup_s = timed_windows(step)
            counts = dict(LAUNCHES)
            med = statistics.median(window_ms)
            expected = [want["augmix_cn" if g else "augmix"] for g in gates]
            emit({"phase": "train_cifar_augmix",
                  "recipe": os.path.relpath(recipe, ROOT),
                  "regime": cfg.regime, "conv3x3": "pallas", "batch": b,
                  "views": 3, "dtype": "bfloat16", "cli_train_s": train_s,
                  "cli_log_rows": rows, "cli_eval_test_error": test_error,
                  "steps": TRAIN_STEPS, "gated_steps": int(gates.sum()),
                  "expected_per_step": want, "launches": counts,
                  "loss_first": losses[0].item(),
                  "loss_last": losses[-1].item(),
                  "warmup_s": warmup_s, "windows_ms_per_step": window_ms,
                  "ms_per_step": med, "img_per_s": b / med * 1e3,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "card": nvidia_smi_name_power()})
            bad = [(i, g, w) for i, (g, w) in enumerate(zip(per_step,
                                                            expected))
                   if g != w]
            check(not bad, f"{recipe} launches per step: {bad[:2]}")
            check(bool(torch.isfinite(losses).all()),
                  f"losses {losses.tolist()}")
            out[model] = counts
            step_ms[model] = med
            del state, images3
            torch.cuda.empty_cache()
        _, rows, _, _, train_s = cli_train_eval(
            ["--config", ALLCONV_AUGMIX, "--device", str(dev),
             "synthetic_data=true", "compute_dtype=bf16", "no_jsd=true"], 1,
            os.path.join(tmp, "allconv"), log)
        check(math.isfinite(float(rows[-1][2])), f"no_jsd train loss {rows}")
        emit({"phase": "train_cifar_augmix_no_jsd",
              "recipe": os.path.relpath(ALLCONV_AUGMIX, ROOT),
              "cli_train_s": train_s, "cli_log_rows": rows})
    return out, step_ms


def phase_augmix_card_vs_cpu(dev):
    """One float32 ``augmix_cn`` step of a WRN of depth 10 and one
    ``cn_image_augmix`` step of ResNet-50-IBN-b at layers (1, 1, 1, 1)
    (``train/rounding.py::run_augmix_step``: fixed views, masks, draws and
    permutation), card and CPU each against a float64 twin that replays
    their ReLU masks, the card within CARD_VS_CPU_ROUNDING × the CPU's
    error (``card_vs_cpu_step``), its launches counted: the WRN's 7
    BatchNorms and 3 fused CNSN sites over three forwards; IBN-b's 16
    BatchNorms and 4 SelfNorms over one 3B forward, and the image
    statistics."""
    from cnsn_tpu_torch.train.rounding import run_augmix_step
    want = {"augmix_cn": {"bn_sums": 3 * CN_STEP_BN,
                          "bn_sums_bwd": 3 * CN_STEP_BN,
                          "ins_stats": 3 * 3, "ins_stats_bwd": 3 * 3},
            "cn_image_augmix": {"bn_sums": 16, "bn_sums_bwd": 16,
                                "ins_stats": 4 + 1, "ins_stats_bwd": 4}}
    shape = {"augmix_cn": (3 * 8, 32), "cn_image_augmix": (3 * 4, 64)}
    for kind, counts in want.items():
        card_vs_cpu_step(
            dev, {"phase": "augmix_card_vs_cpu", "model": kind,
                  "batch": shape[kind][0], "image": shape[kind][1]},
            lambda device, dtype, _k=kind, **kw: run_augmix_step(
                device, dtype, _k, **kw), counts, seeds=range(4))


def _chain_vs_cpu(dev, images, params, norm):
    """The chain on the card (once under sync debug mode 'error') and on
    the CPU from the same images and draws: the pixels (the normalized
    difference times 255·std) past CHAIN_PIXEL_TOL, which a rounding moved
    across a later op's step, held to CHAIN_FLIP_SHARE; the worst of the
    others; the CPU's seconds."""
    from cnsn_tpu_torch.data.augmix_device import apply_augmix
    images_dev = images.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = apply_augmix(images_dev, params, **norm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(got.device == images_dev.device and got.dtype == torch.float32,
          f"the views on {got.device}, {got.dtype}")
    t0 = time.perf_counter()
    want = apply_augmix(images, params, **norm)
    cpu_s = time.perf_counter() - t0
    diff = (got.cpu() - want).abs() * (torch.tensor(norm["std"]) * 255)
    flips = int((diff > CHAIN_PIXEL_TOL).sum())
    worst = float(diff[diff <= CHAIN_PIXEL_TOL].max())
    check(flips <= CHAIN_FLIP_SHARE * diff.numel(),
          f"chain card vs CPU: {flips} of {diff.numel()} pixels past "
          f"{CHAIN_PIXEL_TOL}")
    check(bool(torch.isfinite(want).all()), "finite views")
    return {"pixels": diff.numel(), "flips": flips,
            "max_err_of_the_rest": worst, "cpu_s": cpu_s}


def phase_augmix_device_vs_cpu(dev, imagenet_host_ms):
    """On-device AugMix (``data/augmix_device.py``) on the card against
    the CPU with the same images and draws (``_chain_vs_cpu``, the first
    card call under sync debug mode 'error'): CIFAR 32² at b=128 (0.5/0.5,
    the recipes' severity 3) and ImageNet 224² at b=IBN_BATCH (its
    statistics, the IBN-b recipe's severity 1).  Then ms a batch on the
    card, CHAIN_TIMED batches each with new draws as the Trainer calls it
    (host wall time, the draws and the grouping included, and device time
    by events; the median of CHAIN_TIMED, each waited for), beside the
    host AugMix's ms a batch: CIFAR's from a CifarLoader 'train_augmix'
    in this process (train_ondevice_augmix times its worker processes in
    a Trainer), ImageNet's from phase imagenet_loader (its worker
    pool)."""
    from cnsn_tpu_torch.data import (IMAGENET_MEAN, IMAGENET_STD, CifarLoader,
                                     load_cifar)
    from cnsn_tpu_torch.data.augmix_device import augmix_batch, draw_augmix
    imagenet_norm = {"mean": tuple(map(float, IMAGENET_MEAN)),
                     "std": tuple(map(float, IMAGENET_STD))}
    for name, hw, b, norm, severity in (
            ("cifar", WRN_IMAGE, 128, CIFAR_NORM, 3.0),
            ("imagenet", IMAGE, IBN_BATCH, imagenet_norm, 1.0)):
        gen = torch.Generator().manual_seed(hw)
        images = torch.randint(0, 256, (b, hw, hw, 3), generator=gen,
                               dtype=torch.uint8)
        torch.cuda.reset_peak_memory_stats()
        err = _chain_vs_cpu(dev, images, draw_augmix(gen, b, severity),
                            norm)
        images_dev = images.to(dev)
        augmix_batch(gen, images_dev, severity, **norm)
        torch.cuda.synchronize()
        wall_ms, device_ms = [], []
        for _ in range(CHAIN_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            views = augmix_batch(gen, images_dev, severity, **norm)
            end.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
        check(views.shape == (3, b, hw, hw, 3)
              and bool(torch.isfinite(views).all()), f"views {views.shape}")
        row = {"phase": "augmix_device_vs_cpu", "data": name, "batch": b,
               "image": hw, "severity": severity, **err,
               "tol": {"pixel": CHAIN_PIXEL_TOL, "flip_share":
                       CHAIN_FLIP_SHARE},
               "sync_debug_mode": "error",
               "card_ms_per_batch": statistics.median(wall_ms),
               "card_ms_per_batch_each": wall_ms,
               "card_device_ms_per_batch": statistics.median(device_ms),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if name == "cifar":
            train = load_cifar("", "cifar10", True, synthetic=True,
                               synthetic_size=3 * b)
            ms, _ = time_loader(CifarLoader(train, b, mode="train_augmix"))
            row["host_ms_per_batch_procs0"] = ms
        else:
            row[f"host_ms_per_batch_procs{os.cpu_count() - 1}"] = \
                imagenet_host_ms
        row["card"] = nvidia_smi_name_power()
        emit(row)
        del views, images_dev
        torch.cuda.empty_cache()


def _timed_epoch(trainer, names):
    """One ``train_epoch`` of ``trainer``: the launches of the whole epoch
    (read from the counters, so a launch outside the steps shows) and of
    its steps, the first recorded step's counts of each step kind that
    ran, ms a step from the second step's call to the end of the last
    (the first waits for the pipeline to fill), the wait per staged batch
    and the peak memory."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    rec = StepCounts(trainer, names)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    loss = trainer.train_epoch()
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    n = len(rec.times)
    summed = collections.Counter()
    for c in rec.per_step:
        summed.update(c)
    check(launches == dict(summed), f"epoch launches {launches}, its steps"
          f" summed {dict(summed)}")
    first = {}
    for c, kind in zip(rec.per_step, rec.names):
        first.setdefault(kind, c)
    return {"steps": n, "names": rec.names, "per_step": rec.per_step,
            "first_per_step": first, "launches": launches,
            "ms_per_step": (time.perf_counter() - rec.times[1]) * 1e3
            / (n - 1), "data_wait_ms": trainer.data_wait.avg * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss": loss}


def phase_train_ondevice_augmix(dev, data_dir, cifar_step_ms, ibn_step_ms):
    """``ondevice_augmix`` through the entry points a user calls.

    (a) ``cli train`` + ``cli eval resume=`` of WRN-40-2's
    cifar10/wideresnet/cnsn-augmix.yaml with ondevice_augmix=true: one
    synthetic epoch (4 steps of b=128), bf16, CNSN_CONV3X3=pallas.
    (b) Trainers of that recipe on the synthetic set at
    ONDEVICE_CIFAR_TRAIN images, with
    ondevice_augmix and with host AugMix in os.cpu_count() − 1 worker
    processes: ms a step through ``train_epoch`` of each, beside
    train_cifar_augmix's step alone (``cifar_step_ms``), the wait per
    staged batch and the peak memory; each step's K1, K2 and K4 launches
    against ``expected_launches`` (the host path's: the chain launches
    none).
    (c) ``cli train`` of imagenet/resnet50_ibn_b/cnsn-augmix.yaml with
    ondevice_augmix=true batch_size=IBN_BATCH on 2·IBN_BATCH images of the
    fake folder (2 steps), then Trainers of it on 3·IBN_BATCH images (3
    steps), on-device and host AugMix as in (b),
    beside train_resnet_ibn_augmix's step alone (``ibn_step_ms``); K2 52
    and K1 16 each way a step, K1 one more on a cn_image_augmix step."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.data import CifarLoader, load_cifar
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train.trainer import Trainer
    out_dir = os.path.join(ROOT, "chiprun_out", "train_ondevice_augmix")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = os.path.join(out_dir, "cli.txt")
    recipe = CIFAR_AUGMIX_RECIPES[0]
    ncpu = os.cpu_count()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a)
        LAUNCHES.clear()
        _, rows, _, test_error, train_s = cli_train_eval(
            ["--config", recipe, "--device", str(dev),
             "synthetic_data=true", "compute_dtype=bf16",
             "ondevice_augmix=true"], 1, os.path.join(tmp, "wrn"), log)
        check(math.isfinite(float(rows[-1][2])), f"train loss {rows}")
        emit({"phase": "train_ondevice_augmix", "part": "cli_wrn",
              "recipe": os.path.relpath(recipe, ROOT), "cli_train_s": train_s,
              "cli_log_rows": rows, "cli_eval_test_error": test_error,
              "launches": dict(LAUNCHES)})
        # (b)
        train = load_cifar("", "cifar10", True, synthetic=True,
                           synthetic_size=ONDEVICE_CIFAR_TRAIN)
        runs, names = {}, {}
        for ondevice in (True, False):
            cfg = load_config(recipe, synthetic_data=True,
                              compute_dtype="bf16", snapshot=False,
                              ondevice_augmix=ondevice, print_freq=10_000,
                              augmix_workers=0 if ondevice else ncpu - 1,
                              exp_dir=os.path.join(tmp, f"t{ondevice}"))
            with env_vars(CNSN_CONV3X3="pallas"):
                trainer = Trainer(cfg, device=dev)
            try:
                trainer.train_loader.close()
                trainer.train_loader = CifarLoader(
                    train, cfg.batch_size,
                    mode="train_geom" if ondevice else "train_augmix",
                    seed=cfg.seed, workers=cfg.augmix_workers)
                with contextlib.redirect_stdout(open(log, "a")):
                    run = _timed_epoch(trainer, ("augmix_cn", "augmix"))
            finally:
                trainer.close()
            k4 = k4_paths_per_forward(trainer.state.model, dev)
            want = {kind: expected_launches(trainer.state.model, cfg, kind,
                                            k4)
                    for kind in ("augmix", "augmix_cn")}
            bad = [(i, g, want[n]) for i, (g, n) in enumerate(
                zip(run["per_step"], run["names"])) if g != want[n]]
            check(not bad and run["steps"] == len(train.images)
                  // cfg.batch_size, f"ondevice={ondevice} launches per step"
                  f" {bad[:2]}")
            check(math.isfinite(run["loss"]), f"loss {run['loss']}")
            key = "ondevice" if ondevice else "host_augmix"
            names[key] = run["names"]
            runs[key] = {k: run[k] for k in (
                "steps", "first_per_step", "launches", "ms_per_step",
                "data_wait_ms", "peak_mem_gib", "loss")}
            del trainer
            torch.cuda.empty_cache()
        check(names["ondevice"] == names["host_augmix"],
              "the same gates on both paths")
        runs["gated_steps"] = names["ondevice"].count("augmix_cn")
        out["cifar"] = runs
        emit({"phase": "train_ondevice_augmix", "part": "trainer_wrn",
              "recipe": os.path.relpath(recipe, ROOT), "batch": 128,
              "dtype": "bfloat16", "conv3x3": "pallas",
              "step_only_ms": cifar_step_ms, "expected_per_step": want,
              **runs, "host_procs": ncpu - 1, "card": nvidia_smi_name_power()})
        # (c)
        files = sorted(glob.glob(os.path.join(data_dir, "train", "*", "*")))
        subsets = {}
        for n in (2, 3):
            small = os.path.join(tmp, f"ibn{n}")
            for f in files[:n * IBN_BATCH]:
                d = os.path.join(small, "train",
                                 os.path.basename(os.path.dirname(f)))
                os.makedirs(d, exist_ok=True)
                os.symlink(f, os.path.join(d, os.path.basename(f)))
            os.symlink(os.path.join(data_dir, "validation"),
                       os.path.join(small, "validation"))
            subsets[n] = small
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with env_vars(CNSN_CONV3X3="conv"):
            _cli(["train", "--config", IBN_RECIPE, "--device", str(dev),
                  f"data_dir={subsets[2]}", "compute_dtype=bf16", "epochs=1",
                  f"batch_size={IBN_BATCH}", "ondevice_augmix=true",
                  f"exp_dir={tmp}/ibn_exp"], log)
        cli_s = time.perf_counter() - t0
        cli_counts = dict(LAUNCHES)
        [exp_dir] = glob.glob(f"{tmp}/ibn_exp/*/*")
        row = open(os.path.join(exp_dir, "log.txt")).read().splitlines()[-1]
        check(math.isfinite(float(row.split("\t")[2])), f"log.txt row {row}")
        cfg = load_config(IBN_RECIPE)
        gates = np.random.RandomState(cfg.seed).rand(2)
        check(cli_counts.get("bn_sums") == 2 * (BN_LAYERS - 1)
              and cli_counts.get("ins_stats") == 2 * SN_SITES + int(
                  (gates < cfg.cn_prob).sum())
              and cli_counts.get(K3_STAGED) == SN_SITES,
              f"IBN-b ondevice cli train launches {cli_counts}")
        plain = {"bn_sums": BN_LAYERS - 1, "bn_sums_bwd": BN_LAYERS - 1,
                 "ins_stats": SN_SITES, "ins_stats_bwd": SN_SITES}
        want = {"augmix": plain,
                "cn_image_augmix": dict(plain, ins_stats=SN_SITES + 1)}
        runs = {}
        for ondevice in (True, False):
            cfg = load_config(IBN_RECIPE, data_dir=subsets[3],
                              compute_dtype="bf16", batch_size=IBN_BATCH,
                              snapshot=False, ondevice_augmix=ondevice,
                              augmix_workers=0 if ondevice else ncpu - 1,
                              print_freq=10_000,
                              exp_dir=os.path.join(tmp, f"i{ondevice}"))
            with env_vars(CNSN_CONV3X3="conv"):
                trainer = Trainer(cfg, device=dev)
            try:
                with contextlib.redirect_stdout(open(log, "a")):
                    run = _timed_epoch(trainer,
                                       ("cn_image_augmix", "augmix"))
            finally:
                trainer.close()
            bad = [(i, g) for i, (g, n) in enumerate(
                zip(run["per_step"], run["names"])) if g != want[n]]
            check(not bad and run["steps"] == 3,
                  f"IBN-b ondevice={ondevice} launches per step {bad[:2]}")
            check(math.isfinite(run["loss"]), f"loss {run['loss']}")
            runs["ondevice" if ondevice else "host_augmix"] = {
                k: run[k] for k in ("steps", "names", "first_per_step",
                                    "launches", "ms_per_step",
                                    "data_wait_ms", "peak_mem_gib", "loss")}
            del trainer
            torch.cuda.empty_cache()
        check(runs["ondevice"]["names"] == runs["host_augmix"]["names"],
              "the same gates on both paths")
        out["ibn"] = {"cli": cli_counts, **runs}
        emit({"phase": "train_ondevice_augmix", "part": "trainer_ibn",
              "recipe": os.path.relpath(IBN_RECIPE, ROOT),
              "batch": IBN_BATCH, "dtype": "bfloat16", "cli_train_s": cli_s,
              "cli_launches": cli_counts, "cli_log_row": row,
              "step_only_ms": ibn_step_ms, "expected_per_step": want,
              **runs, "host_procs": ncpu - 1, "card": nvidia_smi_name_power()})
    return out


def _rel_err(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _bn_card_vs_cpu(dev, kw, dtype, x, r, init):
    """One training forward and backward of ``BatchNorm(**kw)`` on the
    card and on the CPU from the same state: the card's error in the
    output, the running statistics and the gradients (x, weight, bias),
    each relative to the largest element of the CPU's; K2's launches on
    the card."""
    from cnsn_tpu_torch.nn import BatchNorm
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    res = {}
    for d in (dev, torch.device("cpu")):
        bn = BatchNorm(x.shape[1], **kw)
        bn.load_state_dict(init)
        bn = bn.to(d).train()
        xd = x.to(device=d, dtype=dtype, copy=True).requires_grad_(True)
        LAUNCHES.clear()
        out = bn(xd)
        (out.float() * r.to(d)).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        check(out.is_contiguous(memory_format=torch.channels_last),
              "BatchNorm keeps channels_last")
        res[d.type] = (out, bn.running_mean, bn.running_var, xd.grad,
                       bn.weight.grad, bn.bias.grad)
    names = ("out", "running_mean", "running_var", "grad_x", "grad_weight",
             "grad_bias")
    return {n: _rel_err(a, b) for n, a, b in zip(names, res["cuda"],
                                                  res["cpu"])}, launches


def phase_bn_options_card_vs_cpu(dev):
    """BatchNorm's options and SelfNorm(is_two=True) on the card.

    (a) ``BatchNorm`` with groups 2 and 4, stats_sample BN_SAMPLE and
    var_impl 'two' and 'one', in fp32 and bf16, at WRN-40-2's (128, 64,
    16, 16) channels_last: one training forward and backward on the card
    against the CPU (``_bn_card_vs_cpu``), K2 once each way at stats_sample
    and never otherwise.  (b) K2 forward and backward on the leading
    BN_SAMPLE rows of WRN-40-2's BatchNorm inputs at b=128 bf16 against
    their plain versions, timed (``_k2_rows``).  (c) K2's launches in one
    WRN-40-2 sn.yaml step (bf16, pallas) under CNSN_BN_VAR=two,
    CNSN_BN_GROUPS=2, CNSN_BN_SAMPLE=BN_SAMPLE and by default, and the
    step's ms (BN_OPT_STEPS steps after 2).  (d) SelfNorm(is_two=True) on
    the card against the CPU: a training forward and backward (K1 each
    way) and an eval forward (K1, no K3), fp32 and bf16."""
    from cnsn_tpu_torch.nn import SelfNorm
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    gen = torch.Generator().manual_seed(17)
    shape = (128, 64, 16, 16)
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.8).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn(shape, generator=gen)
    init = {"weight": torch.rand(64, generator=gen) + 0.5,
            "bias": torch.randn(64, generator=gen) * 0.1,
            "running_mean": torch.randn(64, generator=gen) * 0.3 + 0.8,
            "running_var": torch.rand(64, generator=gen) + 0.5}
    for kw in BN_OPTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            errs, launches = _bn_card_vs_cpu(dev, kw, dtype, x, r, init)
            tol = dict(BN_OPT_TOL, **(BN_OPT_TOL_BF16
                                      if dtype == torch.bfloat16 else {}))
            k2 = int("stats_sample" in kw)
            row = {"phase": "bn_options_card_vs_cpu", "options": kw,
                   "dtype": str(dtype).split(".")[1], "shape": list(shape),
                   "errors": errs, "tol": tol, "launches": launches}
            emit(row)
            check(all(errs[k] <= tol[k] for k in errs),
                  f"BatchNorm {kw} {dtype} card vs CPU {errs}")
            check(launches.get("bn_sums", 0) == k2
                  and launches.get("bn_sums_bwd", 0) == k2,
                  f"BatchNorm {kw} launches {launches}")
    # (b)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(18)
    k2_rows = []
    for h, c, sites in WRN_BN_SHAPES:
        k2_rows += _k2_rows((128, h, h, c), torch.bfloat16, sites, flush, g,
                            lead=BN_SAMPLE, model="wrn_stats_sample",
                            phase="bn_options_card_vs_cpu")
    del flush
    # (c)
    steps_ms, per_step = {}, {}
    for name, env in (("default", {}), ("CNSN_BN_VAR=two", {"CNSN_BN_VAR":
                                                             "two"}),
                      ("CNSN_BN_GROUPS=2", {"CNSN_BN_GROUPS": 2}),
                      (f"CNSN_BN_SAMPLE={BN_SAMPLE}",
                       {"CNSN_BN_SAMPLE": BN_SAMPLE})):
        with env_vars(**env):
            cfg, state, steps = _cifar_model(dev, WRN_RECIPE)
            images = torch.randn(128, WRN_IMAGE, WRN_IMAGE, 3,
                                 generator=gen).to(dev)
            labels = torch.randint(0, 10, (128,), generator=gen).to(dev)
            counts = []
            for _ in range(2):
                step_launches(lambda: steps.plain(state, images, labels),
                              counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BN_OPT_STEPS):
                _, m = steps.plain(state, images, labels)
            loss = float(m["loss"])
            steps_ms[name] = (time.perf_counter() - t0) * 1e3 / BN_OPT_STEPS
        k2 = WRN_BN if name in ("default", f"CNSN_BN_SAMPLE={BN_SAMPLE}") \
            else 0
        check(all(c.get("bn_sums", 0) == k2 and c.get("bn_sums_bwd", 0) == k2
                  and c.get("ins_stats") == WRN_SN for c in counts)
              and math.isfinite(loss), f"WRN sn.yaml {name}: {counts[-1]}")
        per_step[name] = counts[-1]
        del state
    emit({"phase": "bn_options_card_vs_cpu", "part": "wrn_sn_step",
          "recipe": os.path.relpath(WRN_RECIPE, ROOT), "batch": 128,
          "dtype": "bfloat16", "conv3x3": "pallas",
          "launches_per_step": per_step, "ms_per_step": steps_ms,
          "card": nvidia_smi_name_power()})
    # (d)
    xs = (torch.randn(32, 64, 16, 16, generator=gen) * 1.3 + 0.2).contiguous(
        memory_format=torch.channels_last)
    sn = SelfNorm(64, is_two=True, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        res = {}
        for d in (dev, torch.device("cpu")):
            m = copy.deepcopy(sn).to(d)
            xd = xs.to(device=d, dtype=dtype, copy=True).requires_grad_(
                True)
            LAUNCHES.clear()
            out = m.train()(xd)
            (out.float() * r[:32].to(d)).sum().backward()
            with torch.no_grad():
                ev = m.eval()(xd.detach())
            if d.type == "cuda":
                torch.cuda.synchronize()
                launches = dict(LAUNCHES)
            res[d.type] = (out, xd.grad, ev, m.f_bn.running_mean,
                           m.g_bn.running_var)
        names = ("train_out", "grad_x", "eval_out", "f_bn_running_mean",
                 "g_bn_running_var")
        errs = {n: _rel_err(a, b) for n, a, b in zip(names, res["cuda"],
                                                      res["cpu"])}
        t = BN_OPT_TOL_BF16["out"] if dtype == torch.bfloat16 \
            else BN_OPT_TOL["out"]
        tol = {n: (t if n in ("train_out", "grad_x", "eval_out")
                   else BN_OPT_TOL["running_mean"]) for n in names}
        emit({"phase": "bn_options_card_vs_cpu", "part": "selfnorm_is_two",
              "dtype": str(dtype).split(".")[1], "errors": errs, "tol": tol,
              "launches": launches})
        check(all(errs[n] <= tol[n] for n in names),
              f"SelfNorm is_two {dtype} card vs CPU {errs}")
        check(launches == {"ins_stats": 2, "ins_stats_bwd": 1},
              f"SelfNorm is_two launches {launches}")
    torch.cuda.empty_cache()
    return {"k2_rows": k2_rows, "wrn_sn": per_step}


def seg_config(recipe, **over):
    """A segmentation recipe's ``SegConfig``, as ``cli seg-train`` reads
    it: the YAML, then ``over``."""
    import yaml
    from cnsn_tpu_torch.segmentation.trainer import SegConfig
    with open(recipe) as f:
        data = yaml.safe_load(f) or {}
    data.update(over)
    return SegConfig(**data)


def seg_site_shapes(model, dev, size, modules=None):
    """(H, W, C) of every BatchNorm2d's and SelfNorm's input (of those in
    ``modules``, default all) in a forward of ``model`` at ``size``²,
    counted: its K2 and K1/K3 shapes."""
    from cnsn_tpu_torch.nn.cnsn import SelfNorm
    from cnsn_tpu_torch.nn.norm import BatchNorm
    bn, sn = collections.Counter(), collections.Counter()

    def record(counter):
        return lambda mod, inp: counter.update(
            [(inp[0].shape[2], inp[0].shape[3], inp[0].shape[1])])

    hooks = [m.register_forward_pre_hook(record(bn if isinstance(
        m, BatchNorm) else sn)) for m in (modules or model.modules())
        if isinstance(m, (BatchNorm, SelfNorm))]
    with torch.no_grad():
        model.eval()(torch.zeros(1, size, size, 3, device=dev))
    for h in hooks:
        h.remove()
    return bn, sn


def _k2_rows(shape, dtype, sites, flush, gen, lead=None, **tag):
    """K2 forward and backward at ``shape`` in ``dtype`` against their
    plain versions (forward: 1e-5 of Σ|x−m0| and of s2; backward: 1e-6
    of max|dx| in fp32, 2^-7 in bf16), each bit for bit run to run: its
    two ``_row`` lines, with times, bound and ``torch.var_mean``.  With
    ``lead``, x is the leading ``lead`` rows of that batch, in place, as
    BatchNorm's stats_sample hands them to K2."""
    from cnsn_tpu_torch.ops import (bn_sums_bwd_cuda, bn_sums_bwd_reference,
                                    bn_sums_cuda, bn_sums_reference)
    from cnsn_tpu_torch.ops.kernels.bn_stats import (bn_bwd_plan_of,
                                                     bn_sums_plan)
    dev, c = gen.device, shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 1.5
         + 0.5).to(dtype)
    if lead is not None:
        x = x[:lead]
    m0 = torch.randn(c, generator=gen, device=dev) * 0.3
    elems, size = x.numel(), x.element_size()
    s1, s2 = bn_sums_cuda(x, m0)
    a1, a2 = bn_sums_cuda(x, m0)
    w1, w2 = bn_sums_reference(x, m0)
    torch.cuda.synchronize()
    check(torch.equal(s1, a1) and torch.equal(s2, a2),
          f"K2 forward {shape} {dtype} run to run")
    d_abs = (x.float() - m0).abs().sum(dim=(0, 1, 2))
    err = max((s1 - w1).abs().max().item(), (s2 - w2).abs().max().item())
    check(bool(((s1 - w1).abs() <= 1e-5 * d_abs).all())
          and bool(((s2 - w2).abs() <= 1e-5 * w2).all()),
          f"K2 forward {shape} {dtype}: {err}")
    rows = [_row(
        "bn_sums", x.shape, dtype, sites, err,
        {"s1_of_sum_abs": 1e-5, "s2_rtol": 1e-5}, flush,
        lambda: bn_sums_cuda(x, m0), lambda: bn_sums_reference(x, m0),
        lambda: torch.var_mean(x, dim=(0, 1, 2)), "torch.var_mean",
        elems * size + 3 * c * 4, 4 * elems, plan=bn_sums_plan(x), **tag)]
    g1 = torch.randn(c, generator=gen, device=dev)
    g2 = torch.randn(c, generator=gen, device=dev) * 1e-3
    got = bn_sums_bwd_cuda(x, m0, g1, g2)
    again = bn_sums_bwd_cuda(x, m0, g1, g2)
    want = bn_sums_bwd_reference(x, m0, g1, g2)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K2 backward {shape} {dtype} run to run")
    err = (got.float() - want.float()).abs().max().item()
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
    check(err <= rtol * want.float().abs().max().item(),
          f"K2 backward {shape} {dtype}: {err}")
    rows.append(_row(
        "bn_sums_bwd", x.shape, dtype, sites, err, {"of_max_abs": rtol},
        flush, lambda: bn_sums_bwd_cuda(x, m0, g1, g2),
        lambda: bn_sums_bwd_reference(x, m0, g1, g2), None,
        "null: no single PyTorch call computes this backward",
        2 * elems * size + 3 * c * 4, 4 * elems, plan=bn_bwd_plan_of(x),
        equal_to_plain=torch.equal(got, want), **tag))
    return rows


def phase_seg_kernels_vs_plain(dev, flush):
    """K1 (forward at SelfNorm's eps, and backward), K2 (forward and
    backward) at every distinct shape of gtav_fcn50_cnsn.yaml's training
    step (b=16 713², float32: its 16 SelfNorm sites at 179² and 90², its
    55 BatchNorm2d inputs from the stem's 357² × 64 down), and K3 at the
    SelfNorm sites at the eval batch of 8, each against its plain version
    with times, bound and library call, after a clean-L2 flush.  The
    shapes are read from a forward of the recipe's model; the aug step's
    CrossNorm takes one more K1 call at its active site's (SelfNorm's)
    shape, at eps 1e-5."""
    from cnsn_tpu_torch.ops import (ins_stats_bwd_cuda,
                                    ins_stats_bwd_reference, ins_stats_cuda,
                                    ins_stats_reference, selfnorm_infer_cuda,
                                    selfnorm_infer_reference, selfnorm_path)
    from cnsn_tpu_torch.ops.kernels.ins_stats import (ins_bwd_plan_of,
                                                      ins_stats_plan_of)
    from cnsn_tpu_torch.ops.kernels.selfnorm import PATHS, selfnorm_plan
    from cnsn_tpu_torch.segmentation import fcn_cnsn
    cfg = seg_config(SEG_RECIPE)
    model = fcn_cnsn(cfg.classes, generator=torch.Generator()).to(dev)
    bn, sn = seg_site_shapes(model, dev, cfg.train_h)
    del model
    check(sum(bn.values()) == SEG_BN and sum(sn.values()) == SEG_SN,
          f"seg BN shapes {dict(bn)}, SelfNorm shapes {dict(sn)}")
    gen = torch.Generator(device=dev).manual_seed(21)
    b, bval, f32 = cfg.batch_size, cfg.batch_size_val, torch.float32
    tag = dict(phase="seg_kernels_vs_plain", model="fcn50_cnsn")
    rows = []
    for (h, w, c), sites in sorted(sn.items()):
        x = torch.randn(b, h, w, c, generator=gen, device=dev) * 1.5 + 0.3
        elems, stats = x.numel(), b * c * 4
        got, want = ins_stats_cuda(x, 1e-12), ins_stats_reference(x, 1e-12)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, want))
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
        rows.append(_row(
            "ins_stats", x.shape, f32, sites, err,
            {"rtol": 1e-5, "atol": 1e-5}, flush,
            lambda: ins_stats_cuda(x, 1e-12),
            lambda: ins_stats_reference(x, 1e-12),
            lambda: torch.std_mean(x, dim=(1, 2)), "torch.std_mean",
            elems * 4 + 2 * stats, 3 * elems, plan=ins_stats_plan_of(x),
            **tag))
        mean, std = want
        gm = torch.randn(b, c, generator=gen, device=dev)
        gs = torch.randn(b, c, generator=gen, device=dev)
        got = ins_stats_bwd_cuda(x, mean, std, gm, gs)
        want = ins_stats_bwd_reference(x, mean, std, gm, gs)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= 1e-6 * want.abs().max().item(),
              f"K1 backward {tuple(x.shape)}: {err}")
        rows.append(_row(
            "ins_stats_bwd", x.shape, f32, sites, err, {"of_max_abs": 1e-6},
            flush, lambda: ins_stats_bwd_cuda(x, mean, std, gm, gs),
            lambda: ins_stats_bwd_reference(x, mean, std, gm, gs), None,
            "null: no single PyTorch call computes this backward",
            2 * elems * 4 + 4 * stats, 4 * elems, plan=ins_bwd_plan_of(x),
            equal_to_plain=torch.equal(got, want), **tag))
        del x, got, want, mean, std
        xe = torch.randn(bval, h, w, c, generator=gen, device=dev) + 0.3
        wf = torch.randn(c, 2, generator=gen, device=dev) * 0.3
        a = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
        bb = torch.randn(c, generator=gen, device=dev) * 0.1
        path = selfnorm_path(xe)
        got = selfnorm_infer_cuda(xe, wf, a, bb)
        want = selfnorm_infer_reference(xe, wf, a, bb)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL[f32])
        rows.append(_row(
            PATHS[path][1], xe.shape, f32, sites,
            (got - want).abs().max().item(), TOL[f32], flush,
            lambda: selfnorm_infer_cuda(xe, wf, a, bb),
            lambda: selfnorm_infer_reference(xe, wf, a, bb), None,
            "null: no single PyTorch call computes the fused SelfNorm",
            2 * xe.numel() * 4 + 4 * c * 4, 5 * xe.numel(), path=path,
            plan=selfnorm_plan(xe), **tag))
        del xe, got, want
    for (h, w, c), sites in sorted(bn.items(), key=lambda kv: -kv[0][0]):
        rows += _k2_rows((b, h, w, c), f32, sites, flush, gen, **tag)
    torch.cuda.empty_cache()
    return rows


def seg_want(bn):
    """K1 and K2 launches per plain and aug step of a GTAV model with
    ``bn`` BatchNorm2d layers and the recipe's 16 SelfNorm sites: each
    site's statistics and each BatchNorm's sums, forward and backward,
    and on an aug step the active CrossNorm site's content statistics."""
    return {"plain": {"bn_sums": bn, "bn_sums_bwd": bn, "ins_stats": SEG_SN,
                      "ins_stats_bwd": SEG_SN},
            "aug": {"bn_sums": bn, "bn_sums_bwd": bn,
                    "ins_stats": SEG_SN + 1, "ins_stats_bwd": SEG_SN + 1}}


# the FCN-CNSN recipe's, and gtav_fcn50.yaml's (no CNSN: K2 alone)
SEG_WANT = {**seg_want(SEG_BN),
            "base": {"bn_sums": SEG_BN, "bn_sums_bwd": SEG_BN}}


def _seg_trainer(dev, recipe, steps, save_path, **over):
    """A SegTrainer of ``recipe`` on a synthetic set of ``steps`` batches
    of (train_h + 16)² images and SEG_VAL_IMAGES eval images, its steps
    recorded: (trainer, [(kind, launches, step)])."""
    from cnsn_tpu_torch.segmentation.data import synthetic_seg_dataset
    from cnsn_tpu_torch.segmentation.trainer import SegTrainer
    cfg = seg_config(recipe, save_path=save_path, snapshot=False, **over)
    hw = (cfg.train_h + 16, cfg.train_w + 16)
    trainer = SegTrainer(
        cfg, synthetic_seg_dataset(steps * cfg.batch_size, hw=hw,
                                   classes=cfg.classes),
        synthetic_seg_dataset(SEG_VAL_IMAGES, hw=(cfg.train_h, cfg.train_w),
                              classes=cfg.classes, seed=7), device=dev)
    record = []
    for kind in ("plain", "aug"):
        fn = getattr(trainer.steps, kind)

        def step(*a, _fn=fn, _kind=kind, **kw):
            per = []
            out = step_launches(lambda: _fn(*a, **kw), per)
            record.append((_kind, per[0]))
            return out

        setattr(trainer.steps, kind, step)
    return trainer, record


def _time_steps(trainer, kinds):
    """ms of each step ``kinds`` on one staged batch of the trainer's
    loader, after a warm step of each kind; the host waits for each."""
    it = iter(trainer.train_loader)
    images, labels = next(it)
    im = torch.from_numpy(images).to(trainer.device)
    lb = torch.from_numpy(labels).long().to(trainer.device)
    gen = torch.Generator().manual_seed(0)
    out = {k: [] for k in set(kinds)}
    for i, kind in enumerate(tuple(sorted(set(kinds))) + tuple(kinds)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "aug":
            _, m = trainer.steps.aug(trainer.state, im, lb, generator=gen)
        else:
            _, m = trainer.steps.plain(trainer.state, im, lb)
        float(m["loss"])
        if i >= len(set(kinds)):
            out[kind].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def phase_train_seg(dev):
    """gtav_fcn50_cnsn.yaml at its batch (b=16) and shapes (713² crops,
    float32) through ``SegTrainer.train_epoch`` for SEG_STEPS steps on a
    synthetic set, the recipe's mix_prob gate opening both steps: every
    step's K1 and K2 launches against SEG_WANT; the epoch's ms a step
    (the host pipeline included), each step alone on a staged batch, the
    loader alone, img/s and the peak memory; then the same recipe under
    compute_dtype=bfloat16 at b=16 (SEG_BF16_STEPS steps alone), and
    gtav_fcn50.yaml (no CNSN: K2 alone) for SEG_BASE_STEPS trainer steps.
    Returns the recipe's trainer (for seg_eval) and its launches per
    step kind."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    tmp = tempfile.mkdtemp(prefix="seg_")
    trainer, record = _seg_trainer(dev, SEG_RECIPE, SEG_STEPS,
                                   os.path.join(tmp, "cnsn"))
    cfg = trainer.cfg
    check((cfg.arch, cfg.train_h, cfg.batch_size, cfg.compute_dtype,
           cfg.cnsn_type, cfg.pos, cfg.cn_pos, cfg.crop, cfg.block_idxs,
           cfg.mix_prob, cfg.classes)
          == ("fcn_cnsn", 713, 16, None, "cnsn", "residual", "post", "style",
              "1_2_3_4", 0.5, 19), f"{SEG_RECIPE} resolves to {cfg}")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main_loss, miou, macc, aacc = trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    run = dict(LAUNCHES)  # the epoch alone: the timing steps below add more
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kinds = [k for k, _ in record]
    # the launches of the epoch's first plain and first aug step
    per_step = {k: next(got for kind, got in record if kind == k)
                for k in ("plain", "aug")}
    bad = [(i, k, got) for i, (k, got) in enumerate(record)
           if got != SEG_WANT[k]]
    check(len(record) == SEG_STEPS and "aug" in kinds and "plain" in kinds,
          f"seg steps {kinds}")
    check(kinds == ["aug" if g else "plain" for g in trainer.gates],
          f"seg steps {kinds}, gates {trainer.gates}")
    check(not bad, f"seg launches per step: {bad[:2]}")
    check(math.isfinite(main_loss) and 0.0 <= miou <= 1.0,
          f"seg epoch: loss {main_loss}, mIoU {miou}")
    check(sum(run.values()) == sum(sum(got.values()) for _, got in record),
          f"seg epoch launches {run} against its steps' {record}")
    alone = _time_steps(trainer, ("plain", "aug", "plain", "aug"))
    loader_ms, _ = time_loader(itertools.islice(trainer.train_loader, 3))
    b = cfg.batch_size
    step_ms = epoch_ms / SEG_STEPS
    emit({"phase": "train_seg", "recipe": os.path.relpath(SEG_RECIPE, ROOT),
          "batch": b, "image": cfg.train_h, "compute_dtype": "float32",
          "steps": SEG_STEPS, "kinds": kinds, "per_step": per_step,
          "expected_per_step": SEG_WANT, "launches": run,
          "main_loss": main_loss, "mIoU": miou,
          "epoch_ms_per_step": step_ms, "epoch_img_per_s": b / step_ms * 1e3,
          "step_alone_ms": alone,
          "step_alone_img_per_s": {k: b / v * 1e3 for k, v in alone.items()},
          "loader_ms_per_batch": loader_ms,
          "loader_ms_per_batch_mean": statistics.mean(loader_ms),
          "host_threads": torch.get_num_threads(), "peak_mem_gib": peak,
          "host_loadavg": os.getloadavg(), "card": nvidia_smi_name_power()})
    counts = dict(per_step)
    counts["run"] = run
    counts["steps"] = SEG_STEPS
    counts["alone_ms"] = alone
    counts["peak_mem_gib"] = peak

    # the recipe under compute_dtype=bfloat16 at its batch: the steps alone
    del trainer
    torch.cuda.empty_cache()
    bf16, record16 = _seg_trainer(dev, SEG_RECIPE, 1,
                                  os.path.join(tmp, "bf16"),
                                  compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    kinds16 = ("plain", "aug") * (SEG_BF16_STEPS // 2)
    alone16 = _time_steps(bf16, kinds16)
    peak16 = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [(k, got) for k, got in record16 if got != SEG_WANT[k]]
    check(not bad, f"seg bf16 launches per step: {bad[:2]}")
    emit({"phase": "train_seg_bf16", "recipe": os.path.relpath(SEG_RECIPE,
                                                                ROOT),
          "batch": bf16.cfg.batch_size, "compute_dtype": "bfloat16",
          "steps": len(record16), "step_alone_ms": alone16,
          "step_alone_img_per_s": {k: bf16.cfg.batch_size / v * 1e3
                                   for k, v in alone16.items()},
          "peak_mem_gib": peak16, "card": nvidia_smi_name_power()})
    del bf16
    torch.cuda.empty_cache()

    base, record_b = _seg_trainer(dev, SEG_BASE_RECIPE, SEG_BASE_STEPS,
                                  os.path.join(tmp, "base"))
    check((base.cfg.arch, base.cfg.cnsn_type, base.model.cn_num)
          == ("fcn", None, 0), f"{SEG_BASE_RECIPE}: {base.cfg}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base_loss, base_miou, _, _ = base.train_epoch(0)
    torch.cuda.synchronize()
    base_ms = (time.perf_counter() - t0) * 1e3 / SEG_BASE_STEPS
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [(k, got) for k, got in record_b if got != SEG_WANT["base"]]
    check(len(record_b) == SEG_BASE_STEPS and not bad
          and all(k == "plain" for k, _ in record_b),
          f"gtav_fcn50 steps and launches: {record_b[:2]}")
    check(math.isfinite(base_loss), f"gtav_fcn50 loss {base_loss}")
    base_alone = _time_steps(base, ("plain", "plain"))
    emit({"phase": "train_seg_baseline",
          "recipe": os.path.relpath(SEG_BASE_RECIPE, ROOT),
          "batch": base.cfg.batch_size, "compute_dtype": "float32",
          "steps": SEG_BASE_STEPS, "expected_per_step": SEG_WANT["base"],
          "main_loss": base_loss, "mIoU": base_miou,
          "epoch_ms_per_step": base_ms, "step_alone_ms": base_alone,
          "step_alone_img_per_s": {
              k: base.cfg.batch_size / v * 1e3
              for k, v in base_alone.items()},
          "peak_mem_gib": peak_b, "card": nvidia_smi_name_power()})
    counts["base"] = record_b[0][1]
    del base
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return counts


def phase_seg_eval(dev):
    """``SegTrainer.validate`` of gtav_fcn50_cnsn.yaml at batch_size_val 8
    over SEG_VAL_IMAGES synthetic 713² images, through K3: ms a batch
    (the whole validation over its batches, and ``eval_sum`` alone), K3's
    launches a batch by kernel, and which kernel each SelfNorm site
    takes (``selfnorm_path`` of its input)."""
    from cnsn_tpu_torch.nn.cnsn import SelfNorm
    from cnsn_tpu_torch.ops import selfnorm_path
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    with tempfile.TemporaryDirectory() as tmp:
        trainer, _ = _seg_trainer(dev, SEG_RECIPE, 1, tmp)
        bval = trainer.cfg.batch_size_val
        batches = len(trainer.val_loader)
        paths = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, inp: paths.append(
                (list(inp[0].shape), selfnorm_path(inp[0].permute(
                    0, 2, 3, 1))))) for m in trainer.model.modules()
            if isinstance(m, SelfNorm)]
        trainer.validate()
        for h in hooks:
            h.remove()
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res = trainer.validate()
        val_ms = (time.perf_counter() - t0) * 1e3 / batches
        launches = dict(LAUNCHES)
        images, labels = next(iter(trainer.val_loader))
        im = torch.from_numpy(images).to(dev)
        lb = torch.from_numpy(labels).long().to(dev)
        trainer.steps.eval_sum(trainer.state, im, lb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = trainer.steps.eval_sum(trainer.state, im, lb)
        float(out["nll_sum"])
        alone_ms = (time.perf_counter() - t0) * 1e3 / 3
    sites = paths[:SEG_SN]
    emit({"phase": "seg_eval", "recipe": os.path.relpath(SEG_RECIPE, ROOT),
          "batch": bval, "batches": batches, "ms_per_batch": val_ms,
          "eval_sum_alone_ms": alone_ms, "img_per_s": bval / alone_ms * 1e3,
          "launches": launches, "sites": sites, "mIoU": res["mIoU"],
          "loss": res["loss"], "card": nvidia_smi_name_power()})
    check(len(paths) == batches * SEG_SN, f"seg eval sites {len(paths)}")
    check(launches == {K3_STAGED: SEG_SN * batches}
          and all(p == "staged" for _, p in sites),
          f"seg eval launches {launches}, sites {sites}")
    check(math.isfinite(res["loss"]) and 0.0 <= res["mIoU"] <= 1.0,
          f"seg validate {res}")
    return {"launches_per_batch": {k: v / batches
                                   for k, v in launches.items()},
            "ms_per_batch": val_ms, "alone_ms": alone_ms,
            "paths": [p for _, p in sites]}


def phase_seg_card_vs_cpu(dev):
    """One float32 aug step of the reduced FCN-CNSN and of the reduced
    PSPNet (``train/rounding.py::run_seg_step``: layers (1, 1, 1, 1), b=4
    65², one CrossNorm site on, its draws fixed, the fused class-major CE,
    the heads' dropout 0), card and CPU each against a float64 twin that
    replays their ReLU masks, the card within CARD_VS_CPU_ROUNDING × the
    CPU's error (``card_vs_cpu_step``), its launches counted: 19
    BatchNorms for the FCN (17 in the backbone, 2 heads), 23 for PSPNet
    (+ the PPM's 4), 4 SelfNorms and the active CrossNorm site's content
    statistics."""
    from cnsn_tpu_torch.train.rounding import (SEG_BATCH, SEG_SIZE,
                                               run_seg_step)
    for arch, bn in (("fcn_cnsn", 19), ("psp", 23)):
        card_vs_cpu_step(
            dev, {"phase": "seg_card_vs_cpu", "model": f"{arch} (1,1,1,1)",
                  "batch": SEG_BATCH, "image": SEG_SIZE},
            lambda device, dtype, _arch=arch, **kw: run_seg_step(
                device, dtype, arch=_arch, **kw),
            {"bn_sums": bn, "bn_sums_bwd": bn, "ins_stats": 5,
             "ins_stats_bwd": 5}, seeds=range(4))


def phase_seg_cli(dev):
    """``cli seg-train`` of gtav_fcn50_cnsn.yaml, of gtav_fcn50.yaml and of
    gtav_fcn50_cnsn.yaml with arch=psp on the card at the recipes' 713²
    and b=16, one epoch of the CLI's synthetic set (32 images: 2 steps; 8
    eval images: one batch of 8), then ``cli seg-eval
    resume=<seg_ckpt_1>``: the mIoU line seg-eval prints is the last one
    training logged, and the tee log holds it; for arch=psp then ``cli
    seg-export resume=<seg_ckpt_1>``, whose artifact serves the
    checkpoint's eager forward within ARTIFACT_TOL."""
    from cnsn_tpu_torch.segmentation.trainer import build_seg_model
    from cnsn_tpu_torch.serving import load_artifact
    from cnsn_tpu_torch.utils.checkpoint import load_checkpoint
    out_dir = os.path.join(ROOT, "chiprun_out", "seg_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = os.path.join(out_dir, "cli.txt")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for recipe, over in ((SEG_RECIPE, []), (SEG_BASE_RECIPE, []),
                             (SEG_RECIPE, ["arch=psp"])):
            name = os.path.basename(recipe) + "".join(f" {o}" for o in over)
            save = os.path.join(tmp, name.replace(" ", "_"))
            common = ["--config", recipe, "--device", str(dev),
                      "synthetic_data=true", "epochs=1", "print_freq=1",
                      f"save_path={save}", *over]
            t0 = time.perf_counter()
            printed = _cli(["seg-train", *common], log)
            train_s = time.perf_counter() - t0
            lines = re.findall(r"val result: mIoU/mAcc/allAcc (\S+)",
                               printed)
            files = sorted(os.listdir(save))
            check(len(lines) == 1 and {"seg_ckpt_1", "seg_last_ckpt"}
                  <= set(files), f"seg-train printed {lines}, wrote {files}")
            tees = [f for f in files if f.startswith("train-")]
            check(tees and lines[0] in open(os.path.join(save,
                                                         tees[0])).read(),
                  f"seg-train tee log {tees}")
            printed = _cli(["seg-eval", *common,
                            f"resume={os.path.join(save, 'seg_ckpt_1')}"],
                           log)
            again = re.findall(r"val result: mIoU/mAcc/allAcc (\S+)",
                               printed)
            check(again == lines,
                  f"{name}: seg-eval printed {again}, training logged "
                  f"{lines}")
            out[name] = {"seg_train_s": train_s, "val_line": lines[0]}
            if over:
                ckpt = os.path.join(save, "seg_ckpt_1")
                art = os.path.join(tmp, "seg.pt2")
                printed = _cli(["seg-export", *common, "--out", art,
                                f"resume={ckpt}"], log)
                check("exported" in printed and "arch=psp" in printed,
                      f"seg-export printed {printed!r}")
                cfg = seg_config(recipe, arch="psp")
                model = build_seg_model(cfg).to(dev).eval()
                model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
                x = torch.randn(1, cfg.train_h, cfg.train_w, 3, device=dev)
                with torch.no_grad():
                    want = model(x)[0]
                err = (load_artifact(art, dev)(x) - want).abs().max().item()
                scale = want.abs().max().item()
                check(err <= ARTIFACT_TOL * scale,
                      f"seg-export artifact vs eager {err} of {scale}")
                out[name].update(export_max_abs_err=err,
                                 export_max_abs_logit=scale)
                del model
            torch.cuda.empty_cache()
    emit({"phase": "seg_cli", "image": 713, "batch": 16, "recipes": out})


def phase_psp_kernels_vs_plain(dev, flush):
    """K2 forward and backward at the BatchNorm2d shapes the PSP and PSA
    heads add to the FCN's (gtav_fcn50_cnsn.yaml, b=16, fp32 and bf16):
    PSPNet's PPM bins at 713² (16, 64, 144 and 576 rows x 512: the fewest
    rows K2 takes), PSANet's heads at PSA_IMAGE (89² x 512: reduce,
    reduce_p and cls; 45² x 512: attention and attention_p; 45² x 2048:
    proj) and its stem (353² x 64), each through ``_k2_rows``; and K3 at
    the 16 SelfNorm sites of the served PSPNet-CNSN (179² x 256, 90² x
    512/1024/2048) at b=1 and b=4, float32, the kernel its rule picks
    (the staged one, as in the artifact) against the plain version and
    bit for bit run to run, with its plan.  The shapes are read from
    forwards of the recipe's models; times after a clean-L2 flush."""
    from cnsn_tpu_torch.nn.norm import BatchNorm
    from cnsn_tpu_torch.ops import (selfnorm_infer_cuda,
                                    selfnorm_infer_reference, selfnorm_path)
    from cnsn_tpu_torch.ops.kernels.selfnorm import PATHS, selfnorm_plan
    from cnsn_tpu_torch.segmentation import fcn_cnsn
    from cnsn_tpu_torch.segmentation.trainer import build_seg_model
    cfg = seg_config(SEG_RECIPE)
    gen = torch.Generator().manual_seed(0)
    fcn, _ = seg_site_shapes(fcn_cnsn(cfg.classes, generator=gen).to(dev),
                             dev, cfg.train_h)
    psp, psp_sn = seg_site_shapes(build_seg_model(seg_config(
        SEG_RECIPE, arch="psp"), gen).to(dev), dev, cfg.train_h)
    check(sum(psp.values()) == PSP_BN and psp - fcn == collections.Counter(
        {(b, b, 512): 1 for b in (1, 2, 3, 6)}),
        f"PSPNet's BN shapes {dict(psp)} against the FCN's {dict(fcn)}")
    check(sum(psp_sn.values()) == SEG_SN, f"PSPNet's SelfNorm shapes "
          f"{dict(psp_sn)}")
    psa_model = build_seg_model(seg_config(
        SEG_RECIPE, arch="psa", train_h=PSA_IMAGE, train_w=PSA_IMAGE),
        gen).to(dev)
    heads = [m for name, m in psa_model.named_modules()
             if isinstance(m, BatchNorm) and not name.startswith(
                 "backbone.layer")]
    psa, _ = seg_site_shapes(psa_model, dev, PSA_IMAGE, heads)
    check(sum(seg_site_shapes(psa_model, dev, PSA_IMAGE)[0].values())
          == PSA_BN, "PSANet's BN count")
    del psa_model
    cases = [("psp_ppm", shape, n) for shape, n in sorted((psp - fcn).items())]
    cases += [("psa_705", shape, n) for shape, n in sorted(
        psa.items(), key=lambda kv: -kv[0][0] * kv[0][2])]
    b = cfg.batch_size
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for model, (h, w, c), sites in cases:
        for dtype in (torch.float32, torch.bfloat16):
            rows += _k2_rows((b, h, w, c), dtype, sites, flush, gen,
                             phase="psp_kernels_vs_plain", model=model)
    f32 = torch.float32
    tag = dict(phase="psp_kernels_vs_plain", model="psp_served")
    for batch in PSP_SERVED:
        for (h, w, c), sites in sorted(psp_sn.items()):
            x = torch.randn(batch, h, w, c, generator=gen, device=dev) + 0.3
            wf = torch.randn(c, 2, generator=gen, device=dev) * 0.3
            a = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
            bb = torch.randn(c, generator=gen, device=dev) * 0.1
            path = selfnorm_path(x)
            check(path == "staged", f"K3 {tuple(x.shape)} takes {path}")
            got = selfnorm_infer_cuda(x, wf, a, bb)
            again = selfnorm_infer_cuda(x, wf, a, bb)
            want = selfnorm_infer_reference(x, wf, a, bb)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"K3 {tuple(x.shape)} run to run")
            torch.testing.assert_close(got, want, **TOL[f32])
            rows.append(_row(
                PATHS[path][1], x.shape, f32, sites,
                (got - want).abs().max().item(), TOL[f32], flush,
                lambda: selfnorm_infer_cuda(x, wf, a, bb),
                lambda: selfnorm_infer_reference(x, wf, a, bb), None,
                "null: no single PyTorch call computes the fused SelfNorm",
                2 * x.numel() * 4 + 4 * c * 4, 5 * x.numel(), path=path,
                plan=selfnorm_plan(x), **tag))
            del x, got, again, want
    torch.cuda.empty_cache()
    return rows


def phase_train_psp(dev):
    """gtav_fcn50_cnsn.yaml with arch=psp at the recipe's b=16 713²
    float32 through ``SegTrainer.train_epoch`` for PSP_STEPS steps (the
    gate opens the aug step at step 4): every step's K1 and K2 launches
    (K2 59: 53 backbone, 4 PPM, cls, aux), the epoch's ms a step, each
    step alone on a staged batch (plain and aug), img/s and the peak
    memory.  Returns the launches of the epoch's first plain and first
    aug step, and the epoch's (the sum of its steps')."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    want = seg_want(PSP_BN)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, record = _seg_trainer(dev, SEG_RECIPE, PSP_STEPS, tmp,
                                       arch="psp")
        cfg = trainer.cfg
        check((cfg.arch, cfg.train_h, cfg.batch_size, cfg.compute_dtype,
               type(trainer.model).__name__) == ("psp", 713, 16, None,
                                                 "PSPNet"),
              f"arch=psp resolves to {cfg}")
        torch.cuda.synchronize()
        LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        main_loss, miou, _, _ = trainer.train_epoch(0)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        run = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kinds = [k for k, _ in record]
        bad = [(i, k, got) for i, (k, got) in enumerate(record)
               if got != want[k]]
        check(kinds == ["aug" if g else "plain" for g in trainer.gates]
              and set(kinds) == {"plain", "aug"}, f"psp steps {kinds}")
        check(not bad, f"psp launches per step: {bad[:2]}")
        check(sum(run.values()) == sum(sum(got.values())
                                       for _, got in record),
              f"psp epoch launches {run} against its steps' {record}")
        per_step = {k: next(got for kind, got in record if kind == k)
                    for k in ("plain", "aug")}
        check(math.isfinite(main_loss) and 0.0 <= miou <= 1.0,
              f"psp epoch: loss {main_loss}, mIoU {miou}")
        alone = _time_steps(trainer, ("plain", "aug", "plain", "aug"))
        b = cfg.batch_size
        step_ms = epoch_ms / PSP_STEPS
        emit({"phase": "train_psp", "recipe": os.path.relpath(SEG_RECIPE,
                                                              ROOT),
              "arch": "psp", "batch": b, "image": cfg.train_h,
              "compute_dtype": "float32", "steps": PSP_STEPS, "kinds": kinds,
              "per_step": per_step, "expected_per_step": want,
              "launches": run,
              "main_loss": main_loss, "mIoU": miou,
              "epoch_ms_per_step": step_ms,
              "epoch_img_per_s": b / step_ms * 1e3, "step_alone_ms": alone,
              "step_alone_img_per_s": {k: b / v * 1e3
                                       for k, v in alone.items()},
              "peak_mem_gib": peak, "card": nvidia_smi_name_power()})
        del trainer
    torch.cuda.empty_cache()
    return {**per_step, "run": run, "steps": PSP_STEPS, "alone_ms": alone,
            "peak_mem_gib": peak}


def phase_train_psa(dev):
    """arch=psa (psa_type 2, the gathered over-complete map) at PSA_IMAGE
    and arch=psa_lite at 713², the recipe's b=16 float32: a plain and an
    aug step alone on a staged batch, after a warm step of each (each
    step's K1 and K2 launches checked, and their sum against the run's),
    ms a step and the peak memory.  Returns, for each arch, the launches
    of its first plain and first aug step and of its four steps."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    out = {}
    for arch, image, bn in (("psa", PSA_IMAGE, PSA_BN),
                            ("psa_lite", 713, PSA_LITE_BN)):
        want = seg_want(bn)
        with tempfile.TemporaryDirectory() as tmp:
            trainer, record = _seg_trainer(dev, SEG_RECIPE, 1, tmp, arch=arch,
                                           train_h=image, train_w=image)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            torch.cuda.reset_peak_memory_stats()
            alone = _time_steps(trainer, ("plain", "aug"))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            run = dict(LAUNCHES)
            bad = [(k, got) for k, got in record if got != want[k]]
            check(len(record) == 4 and not bad,
                  f"{arch} launches per step: {bad[:2]} of {len(record)}")
            check(sum(run.values()) == sum(sum(got.values())
                                           for _, got in record),
                  f"{arch} launches {run} against its steps' {record}")
            per_step = {k: next(got for kind, got in record if kind == k)
                        for k in ("plain", "aug")}
            b = trainer.cfg.batch_size
            emit({"phase": "train_psa", "recipe": os.path.relpath(
                SEG_RECIPE, ROOT), "arch": arch, "batch": b, "image": image,
                "compute_dtype": "float32", "psa_type": trainer.cfg.psa_type,
                "per_step": per_step, "expected_per_step": want,
                "launches": run, "step_alone_ms": alone,
                "step_alone_img_per_s": {k: b / v * 1e3
                                         for k, v in alone.items()},
                "peak_mem_gib": peak, "card": nvidia_smi_name_power()})
            out[arch] = {**per_step, "run": run, "alone_ms": alone,
                         "peak_mem_gib": peak}
            del trainer
        torch.cuda.empty_cache()
    return out


def phase_seg_export(dev):
    """PSPNet-CNSN (gtav_fcn50_cnsn.yaml arch=psp, random weights from a
    seed) exported at 713² (``serving.export_segmenter``), saved, loaded
    and served at b=1 and b=4: the main head's logits within ARTIFACT_TOL
    of max|logit| of the eager forward, K3's 16 staged launches a served
    forward, the latency (b=1) and ms a batch (b=4), median of
    PSP_REQUESTS after warm-up, eager beside."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.segmentation.trainer import build_seg_model
    from cnsn_tpu_torch.serving import (export_segmenter, load_artifact,
                                        save_artifact)
    cfg = seg_config(SEG_RECIPE, arch="psp")
    hw = (cfg.train_h, cfg.train_w)
    model = build_seg_model(cfg, torch.Generator().manual_seed(0)).to(dev)
    model.eval()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pspnet_cnsn.pt2")
        t0 = time.perf_counter()
        save_artifact(export_segmenter(model, hw), path)
        serve = load_artifact(path, device=dev)
        export_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"export_save_load_s": export_s, "artifact_bytes": nbytes}
    for b in PSP_SERVED:
        x = torch.randn(b, *hw, 3, generator=gen, device=dev)
        with torch.no_grad():
            want = model(x)[0]
        torch.cuda.synchronize()
        LAUNCHES.clear()
        got = serve(x)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(got.shape == (b, *hw, cfg.classes)
              and bool(torch.isfinite(got).all()),
              f"served PSPNet logits {tuple(got.shape)}")
        check(err <= ARTIFACT_TOL * scale,
              f"PSPNet artifact vs eager {err} > {ARTIFACT_TOL} * {scale}")
        check(launches == {K3_STAGED: SEG_SN},
              f"PSPNet artifact launches {launches}")
        times = {}
        for name, fn in (("artifact", serve), ("eager", model)):
            with torch.no_grad():
                for _ in range(3):
                    fn(x)
                lat = []
                for _ in range(PSP_REQUESTS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(x)
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
            times[name] = statistics.median(lat)
        out[b] = {"max_abs_err": err, "max_abs_logit": scale,
                  "launches": launches, "median_ms": times}
        emit({"phase": "seg_export", "arch": "psp", "image": hw[0],
              "batch": b, "max_abs_err": err, "max_abs_logit": scale,
              "tol": f"{ARTIFACT_TOL} x max|logit|", "launches": launches,
              "requests": PSP_REQUESTS, "median_ms": times,
              "img_per_s": {k: b / v * 1e3 for k, v in times.items()},
              "export_save_load_s": export_s, "artifact_bytes": nbytes,
              "card": nvidia_smi_name_power()})
    del model, serve
    torch.cuda.empty_cache()
    return out


# ---- rematerialised blocks, step checkpoints, the NaN guard --------------

REMAT_WARM, REMAT_TIMED = 2, 5  # steps per configuration in train_remat
IBN_RECIPE_BATCH = 256  # resnet50_ibn_b/cnsn-augmix.yaml's own batch
SEG_REMAT_SPECS = (True, "1_2")
SEG_STAGE_BLOCKS = (3, 4, 6, 3)  # bottlenecks per stage of ResNet-50
# a remat step's parameters against the non-remat step's: at most twice
# the spread of two non-remat runs of the same step, or this share of the
# largest update of the tensor (one bf16 rounding of a gradient)
UPDATE_FLOOR = 2 ** -8
PREEMPT_TIMEOUT = 300  # seconds the cli subprocess may take
GUARD_STEPS = 3


def remat_want(per_step, block_bn, block_sn):
    """A step's launches with ``block_bn`` BatchNorm2d layers and
    ``block_sn`` K1 forward calls inside rematerialised blocks: each of
    those forward launches once more, the backward ones as often."""
    out = dict(per_step)
    out["bn_sums"] = out.get("bn_sums", 0) + block_bn
    out["ins_stats"] = out.get("ins_stats", 0) + block_sn
    return out


def _rel_update_err(got, want, start):
    """Per tensor max|got − want| over the largest |want − start| (the
    step's update), the worst tensor's."""
    worst = 0.0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        upd = float((w.double() - start[k].double()).abs().max())
        if upd == 0.0:
            continue
        worst = max(worst, float((got[k].double() - w.double()).abs().max())
                    / upd)
    return worst


def _remat_card_vs_card(dev, label, states, kinds, block_bn, block_sn,
                        base_want):
    """Each step of ``kinds`` ({kind: fn(state)}) from the same start
    (weights, statistics, a fresh optimizer: ``states[remat]()``) on the
    non-remat model twice and the remat model once: the running
    statistics bit for bit, the parameters within the spread, every
    step's K1/K2 launches against ``base_want`` (non-remat) and
    ``remat_want``."""
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    out = {}
    for kind, step in kinds.items():
        runs = {}
        for run, remat in (("a", False), ("b", False), ("remat", True)):
            state = states[remat]()
            start = {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}
            torch.cuda.synchronize()
            LAUNCHES.clear()
            loss = float(step(state)["loss"])
            torch.cuda.synchronize()
            runs[run] = (dict(LAUNCHES), loss,
                         {k: v.detach().clone()
                          for k, v in state.model.state_dict().items()})
            params = {n for n, _ in state.model.named_parameters()}
        stats = [k for k in start if "running" in k]
        pick = (lambda sd, keys: {k: sd[k] for k in keys})
        spread = _rel_update_err(pick(runs["b"][2], params),
                                 pick(runs["a"][2], params), start)
        err = _rel_update_err(pick(runs["remat"][2], params),
                              pick(runs["a"][2], params), start)
        stats_equal = all(torch.equal(runs["remat"][2][k], runs["a"][2][k])
                          for k in stats)
        want = base_want[kind]
        rwant = remat_want(want, block_bn, block_sn)
        got = {r: {k: v for k, v in runs[r][0].items()
                   if k in STATS_FAMILY} for r in runs}
        out[kind] = {"launches": got["a"], "remat_launches": got["remat"],
                     "expected": want, "remat_expected": rwant,
                     "loss": {r: runs[r][1] for r in runs},
                     "running_stats_bit_equal": stats_equal,
                     "running_stats": len(stats),
                     "param_err_vs_update": err,
                     "param_spread_vs_update": spread}
        check(got["a"] == want and got["b"] == want,
              f"{label} {kind}: launches {got['a']}, expected {want}")
        check(got["remat"] == rwant,
              f"{label} {kind} remat: launches {got['remat']}, expected "
              f"{rwant}")
        check(stats_equal, f"{label} {kind}: running statistics differ "
              "with remat")
        check(err <= max(2 * spread, UPDATE_FLOOR),
              f"{label} {kind}: remat parameters off by {err} of the "
              f"update (two non-remat runs: {spread})")
        check(math.isfinite(runs["remat"][1]), f"{label} {kind} loss")
    return out


def _time_plain(state, step):
    """ms a step (REMAT_TIMED after REMAT_WARM, the host waiting for the
    last) and the peak memory of those steps, GiB."""
    for _ in range(REMAT_WARM):
        step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(REMAT_TIMED):
        m = step(state)
    float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3 / REMAT_TIMED
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_remat_card_vs_card(dev):
    """``remat`` on the card against the same steps without it, from the
    same state and draws: the flagship (resnet50/cnsn.yaml, b=128 224²
    bf16) and ResNet-50-IBN-b (cnsn-augmix.yaml at b=IBN_BATCH), a
    gated and a plain step each (``_remat_card_vs_card``); then each
    model's ms a step and peak memory with remat off and on.  Returns
    (launches per step by path, the flagship's ms a step, its state)."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.train import create_train_state, imagenet_step_lr
    cfg, state0, steps, _, _, images, labels = flagship(dev)
    _, state1, _, _, _, _, _ = flagship(dev, remat=True)
    start = {k: v.detach().clone() for k, v in state0.model.state_dict().items()}

    def fresh(state):
        def make():
            state.model.load_state_dict(start)
            return create_train_state(
                state.model, state.schedule, momentum=cfg.momentum,
                weight_decay=cfg.weight_decay, nesterov=cfg.nesterov,
                device=dev)
        return make

    def gated(state):
        gen = torch.Generator(device=dev if cfg.crop == "neither"
                              else "cpu").manual_seed(cfg.seed)
        return getattr(steps, cfg.regime)(state, images, labels,
                                          generator=gen)[1]

    plain = {"bn_sums": BN_LAYERS, "bn_sums_bwd": BN_LAYERS,
             "ins_stats": SN_SITES, "ins_stats_bwd": SN_SITES}
    base = {"plain": plain, "cn_image": dict(plain, ins_stats=SN_SITES + 1)}
    flag = _remat_card_vs_card(
        dev, "flagship", {False: fresh(state0), True: fresh(state1)},
        {"cn_image": gated,
         "plain": lambda st: steps.plain(st, images, labels)[1]},
        BN_LAYERS - 1, SN_SITES, base)
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    timing, trained = {}, {}
    for remat, st in ((False, state0), (True, state1)):
        s = trained[remat] = fresh(st)()
        ms, peak = _time_plain(s, lambda x: steps.plain(x, images, labels)[1])
        # where a remat step's extra time goes: the card's busy time and
        # its idle share against the unprofiled step
        prof = device_time_breakdown(
            lambda: steps.plain(s, images, labels), iters=3, warmup=1, top=8)
        timing["remat" if remat else "off"] = {
            "ms_per_step": ms, "peak_mem_gib": peak,
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share_vs_unprofiled": 1.0 - prof["device_busy_ms"] / ms,
            "busy_by_family_ms": prof.get("by_family_ms")}
    emit({"phase": "remat_card_vs_card", "model": "flagship",
          "recipe": os.path.relpath(RECIPE, ROOT), "batch": cfg.batch_size,
          "image": IMAGE, "dtype": "bfloat16", **flag,
          "update_floor": UPDATE_FLOOR, "card": nvidia_smi_name_power()})
    emit({"phase": "train_remat", "part": "flagship",
          "recipe": os.path.relpath(RECIPE, ROOT), "batch": cfg.batch_size,
          "step": "plain", **timing,
          "remat_over_off": timing["remat"]["ms_per_step"]
          / timing["off"]["ms_per_step"], "card": nvidia_smi_name_power()})
    keep = trained[False]  # weights, statistics and momentum buffers
    del state1, start, trained
    torch.cuda.empty_cache()

    # ResNet-50-IBN-b, the AugMix steps at IBN_BATCH
    icfg = load_config(IBN_RECIPE, compute_dtype="bf16")
    b = IBN_BATCH
    models = {}
    for remat in (False, True):
        with env_vars(CNSN_CONV3X3="conv"):
            models[remat] = build_model(
                icfg.model, icfg.num_classes,
                generator=torch.Generator().manual_seed(icfg.seed),
                pos=icfg.pos, crop=icfg.crop, beta=icfg.beta,
                cnsn_type=icfg.cnsn_type, dtype=torch.bfloat16,
                remat=remat).to(dev)
    istart = {k: v.detach().clone()
              for k, v in models[False].state_dict().items()}
    sched = imagenet_step_lr(icfg.lr, icfg.epochs, icfg.batch_size,
                             STEPS_PER_EPOCH)

    def ifresh(model):
        def make():
            model.load_state_dict(istart)
            return create_train_state(
                model, sched, momentum=icfg.momentum,
                weight_decay=icfg.weight_decay, nesterov=icfg.nesterov,
                device=dev)
        return make

    gen = torch.Generator().manual_seed(icfg.seed)
    images3 = torch.randn(3, b, IMAGE, IMAGE, 3, generator=gen).to(dev)
    ilabels = torch.randint(0, icfg.num_classes, (b,), generator=gen).to(dev)
    from cnsn_tpu_torch.train import StepFns
    isteps = StepFns(image_crop=icfg.crop, image_beta=icfg.beta)

    def igated(state):
        g = torch.Generator(device=dev).manual_seed(icfg.seed)
        return isteps.cn_image_augmix(state, images3, ilabels,
                                      generator=g)[1]

    n_bn = BN_LAYERS - 1  # an InstanceNorm stem: every BatchNorm in a block
    iplain = {"bn_sums": n_bn, "bn_sums_bwd": n_bn, "ins_stats": SN_SITES,
              "ins_stats_bwd": SN_SITES}
    ibase = {"augmix": iplain,
             "cn_image_augmix": dict(iplain, ins_stats=SN_SITES + 1)}
    ibn = _remat_card_vs_card(
        dev, "IBN-b", {False: ifresh(models[False]),
                       True: ifresh(models[True])},
        {"cn_image_augmix": igated,
         "augmix": lambda st: isteps.augmix(st, images3, ilabels)[1]},
        n_bn, SN_SITES, ibase)
    itiming = {}
    for remat in (False, True):
        s = ifresh(models[remat])()
        ms, peak = _time_plain(
            s, lambda x: isteps.augmix(x, images3, ilabels)[1])
        itiming["remat" if remat else "off"] = {"ms_per_step": ms,
                                                "peak_mem_gib": peak}
    emit({"phase": "remat_card_vs_card", "model": "resnet50_ibn_b",
          "recipe": os.path.relpath(IBN_RECIPE, ROOT), "batch": b,
          "views": 3, "image": IMAGE, "dtype": "bfloat16", **ibn,
          "update_floor": UPDATE_FLOOR, "card": nvidia_smi_name_power()})
    emit({"phase": "train_remat", "part": "resnet50_ibn_b", "batch": b,
          "step": "augmix", **itiming,
          "remat_over_off": itiming["remat"]["ms_per_step"]
          / itiming["off"]["ms_per_step"], "card": nvidia_smi_name_power()})
    del models, images3, istart
    torch.cuda.empty_cache()
    paths = {"flagship": {k: v["remat_launches"] for k, v in flag.items()},
             "resnet50_ibn_b": {k: v["remat_launches"]
                                for k, v in ibn.items()}}
    return paths, timing["off"]["ms_per_step"], keep


def phase_train_remat_ibn(dev, data_dir, ibn_step_ms):
    """resnet50_ibn_b/cnsn-augmix.yaml at its own batch_size 256 with
    remat=true and ondevice_augmix=true, bf16: ``cli train`` of one epoch
    on 2·256 images of the fake folder (it finishes; its launches), then
    the step loop at b=256 on pre-made views, ms a step and peak memory
    beside the b=IBN_BATCH non-remat step (``ibn_step_ms``)."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models import build_model
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.train import (StepFns, create_train_state,
                                      imagenet_step_lr)
    out_dir = os.path.join(ROOT, "chiprun_out", "train_remat")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    icfg = load_config(IBN_RECIPE)
    b = icfg.batch_size
    check(b == IBN_RECIPE_BATCH, f"{IBN_RECIPE} batch_size {b}")
    n_bn = BN_LAYERS - 1
    with tempfile.TemporaryDirectory() as tmp:
        small = os.path.join(tmp, "data")
        files = sorted(glob.glob(os.path.join(data_dir, "train", "*", "*")))
        for f in files[:2 * b]:
            d = os.path.join(small, "train",
                             os.path.basename(os.path.dirname(f)))
            os.makedirs(d, exist_ok=True)
            os.symlink(f, os.path.join(d, os.path.basename(f)))
        os.symlink(os.path.join(data_dir, "validation"),
                   os.path.join(small, "validation"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with env_vars(CNSN_CONV3X3="conv"):
            _cli(["train", "--config", IBN_RECIPE, "--device", str(dev),
                  f"data_dir={small}", "compute_dtype=bf16", "epochs=1",
                  "remat=true", "ondevice_augmix=true", f"exp_dir={tmp}/exp"],
                 os.path.join(out_dir, "cli.txt"))
        cli_s = time.perf_counter() - t0
        cli_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        cli_counts = dict(LAUNCHES)
        [exp_dir] = glob.glob(f"{tmp}/exp/*/*")
        row = open(os.path.join(exp_dir, "log.txt")).read().splitlines()[-1]
    gates = np.random.RandomState(icfg.seed).rand(2) < icfg.cn_prob
    want_cli = {"bn_sums": 2 * 2 * n_bn, "bn_sums_bwd": 2 * n_bn,
                "ins_stats": 2 * 2 * SN_SITES + int(gates.sum()),
                "ins_stats_bwd": 2 * SN_SITES, K3_STAGED: SN_SITES}
    got_cli = {k: cli_counts.get(k, 0) for k in want_cli}
    check(got_cli == want_cli, f"IBN-b remat cli train launches {got_cli},"
          f" expected {want_cli}")
    check(math.isfinite(float(row.split("\t")[2])), f"log.txt row {row}")
    torch.cuda.empty_cache()
    # the step loop at the recipe's batch
    with env_vars(CNSN_CONV3X3="conv"):
        model = build_model(icfg.model, icfg.num_classes,
                            generator=torch.Generator().manual_seed(icfg.seed),
                            pos=icfg.pos, crop=icfg.crop, beta=icfg.beta,
                            cnsn_type=icfg.cnsn_type, dtype=torch.bfloat16,
                            remat=True)
    state = create_train_state(
        model, imagenet_step_lr(icfg.lr, icfg.epochs, b, STEPS_PER_EPOCH),
        momentum=icfg.momentum, weight_decay=icfg.weight_decay,
        nesterov=icfg.nesterov, device=dev)
    steps = StepFns(image_crop=icfg.crop, image_beta=icfg.beta)
    gen = torch.Generator().manual_seed(icfg.seed)
    images3 = torch.randn(3, b, IMAGE, IMAGE, 3, generator=gen).to(dev)
    labels = torch.randint(0, icfg.num_classes, (b,), generator=gen).to(dev)
    per = []
    step_launches(lambda: steps.augmix(state, images3, labels), per)
    want = remat_want({"bn_sums": n_bn, "bn_sums_bwd": n_bn,
                       "ins_stats": SN_SITES, "ins_stats_bwd": SN_SITES},
                      n_bn, SN_SITES)
    got = {k: per[0].get(k, 0) for k in want}
    check(got == want, f"IBN-b b={b} remat step launches {got}, expected "
          f"{want}")
    ms, peak = _time_plain(state,
                           lambda s: steps.augmix(s, images3, labels)[1])
    emit({"phase": "train_remat", "part": "resnet50_ibn_b_recipe_batch",
          "recipe": os.path.relpath(IBN_RECIPE, ROOT), "batch": b,
          "remat": True, "ondevice_augmix": True, "dtype": "bfloat16",
          "cli_train_s": cli_s, "cli_launches": cli_counts,
          "cli_expected": want_cli, "cli_log_row": row,
          "cli_peak_mem_gib": cli_peak, "step": "augmix",
          "launches_per_step": got, "ms_per_step": ms,
          "ms_per_image": ms / b, "peak_mem_gib": peak,
          "non_remat_b192_ms_per_step": ibn_step_ms,
          "non_remat_b192_ms_per_image": (None if ibn_step_ms is None
                                          else ibn_step_ms / IBN_BATCH),
          "card": nvidia_smi_name_power()})
    del state, images3
    torch.cuda.empty_cache()
    return {"augmix": got}


def phase_train_remat_seg(dev, seg_counts):
    """gtav_fcn50_cnsn.yaml at b=16 713² float32 with remat=true and
    remat=1_2: each step alone (``_time_steps``: a plain and an aug step),
    their launches (K2 once more per BatchNorm of a rematerialised stage,
    K1 once more per SelfNorm site there, and the active CrossNorm site's
    if it lies there) and the peak memory, beside train_seg's (no
    remat)."""
    out = {}
    stage_sites = dict(zip((1, 2, 3, 4), SEG_STAGE_BLOCKS))
    for spec in SEG_REMAT_SPECS:
        tmp = tempfile.mkdtemp(prefix="seg_remat_")
        trainer, record = _seg_trainer(dev, SEG_RECIPE, 1,
                                       os.path.join(tmp, "s"), remat=spec)
        stages = trainer.model.backbone.remat_stages
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        alone = _time_steps(trainer, ("plain", "aug"))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        blocks = sum(stage_sites[s] for s in stages)
        # 3 BatchNorms a block, and each stage's first block's downsample
        block_bn = 3 * blocks + len(stages)
        bad = []
        for kind, got in record:
            want = remat_want(SEG_WANT[kind], block_bn, blocks)
            got = {k: got.get(k, 0) for k in want}
            # an aug step's active CrossNorm site: once more where its
            # stage is rematerialised
            more = dict(want, ins_stats=want["ins_stats"] + 1)
            ok = (got == want if kind == "plain"
                  else got == more if len(stages) == 4
                  else got in (want, more))
            if not ok:
                bad.append((kind, got, want))
        check(not bad, f"seg remat={spec!r} launches: {bad[:2]}")
        check(all(math.isfinite(v) for v in alone.values()),
              f"seg remat={spec!r} steps {alone}")
        key = "true" if spec is True else str(spec)
        out[key] = {kind: got for kind, got in record}
        emit({"phase": "train_remat", "part": f"seg_remat_{key}",
              "recipe": os.path.relpath(SEG_RECIPE, ROOT), "batch": 16,
              "image": trainer.cfg.train_h, "compute_dtype": "float32",
              "remat": spec, "remat_stages": sorted(stages),
              "step_alone_ms": alone, "peak_mem_gib": peak,
              "launches": [{"kind": k, **g} for k, g in record],
              "no_remat_peak_mem_gib": seg_counts.get("peak_mem_gib"),
              "no_remat_step_alone_ms": seg_counts.get("alone_ms"),
              "card": nvidia_smi_name_power()})
        del trainer
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _session_processes(sid):
    """Live processes of session ``sid``, read from /proc."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(name))
    return pids


def phase_ckpt_preempt(dev, flagship_state, flagship_ms):
    """``ckpt_backend=orbax`` on the card.

    (a) ``cli train`` of WRN-40-2 cnsn.yaml (synthetic, bf16) in a
    subprocess, SIGTERM after 2 steps: exit 143, no process of its
    session left, one step checkpoint flushed.  (b) A Trainer with
    ``resume=<exp>`` (as ``cli train resume=`` builds it): the flushed
    step restored, its state equal to the files, one more step makes it
    step + 1; then ``fit`` over two epochs, each ending in a save: the
    newest two steps kept.  (c) The blocking ms of an async save of the
    flagship's state, and of its write, beside its step.  (d) A
    SegTrainer of gtav_fcn50_cnsn.yaml at its shapes: a step, a save,
    and a second SegTrainer restoring it by itself."""
    import signal

    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.train.trainer import Trainer
    from cnsn_tpu_torch.utils.orbax_io import OrbaxCheckpointer
    out_dir = os.path.join(ROOT, "chiprun_out", "ckpt_preempt")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    recipe = WRN_CN_RECIPES[1]
    tmp = tempfile.mkdtemp(prefix="ckpt_")
    exp = os.path.join(tmp, "exp")
    os.makedirs(exp)
    args = ["--config", recipe, "--device", str(dev), "synthetic_data=true",
            "compute_dtype=bf16", "ckpt_backend=orbax", f"resume={exp}",
            "print_freq=1", "snapshot=false"]
    env = dict(os.environ, PYTHONPATH=ROOT, CNSN_CONV3X3="conv",
               PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "cnsn_tpu_torch.cli", "train",
                          *args, "epochs=100"], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    lines, seen = [], 0
    try:
        for line in p.stdout:
            lines.append(line)
            seen += "Train Loss" in line
            if seen >= 2 or time.perf_counter() - t0 > PREEMPT_TIMEOUT:
                break
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=PREEMPT_TIMEOUT)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    lines.append(rest)
    with open(os.path.join(out_dir, "cli_train.txt"), "w") as f:
        f.write("".join(lines))
    deadline = time.perf_counter() + 20
    while _session_processes(p.pid) and time.perf_counter() < deadline:
        time.sleep(0.2)
    left = _session_processes(p.pid)
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    check(seen >= 2, "the cli's training never reached two steps")
    check(p.returncode == 143, f"SIGTERM'd cli train exited {p.returncode}")
    check(left == [], f"processes left behind: {left}")
    steps_saved = OrbaxCheckpointer(os.path.join(exp, "orbax")).all_steps()
    check(1 <= len(steps_saved) <= 2 and steps_saved[-1] >= 2,
          f"flushed steps {steps_saved}")
    flushed = steps_saved[-1]
    # (b)
    cfg = load_config(recipe, synthetic_data=True, compute_dtype="bf16",
                      ckpt_backend="orbax", resume=exp, snapshot=False,
                      print_freq=10_000)
    previous = signal.getsignal(signal.SIGTERM)
    with env_vars(CNSN_CONV3X3="conv"), \
            contextlib.redirect_stdout(open(os.path.join(out_dir,
                                                         "resume.txt"), "a")):
        trainer = Trainer(cfg, device=dev)
    try:
        payload = torch.load(os.path.join(exp, "orbax", str(flushed),
                                          "state.pt"), weights_only=True)
        sd = trainer.state.model.state_dict()
        equal = all(torch.equal(sd[k].cpu(), v)
                    for k, v in payload["model"].items())
        restored_step = trainer.state.step
        check(restored_step == flushed and equal
              and trainer.start_epoch == payload["extra"]["epoch"],
              f"restored step {restored_step} of {flushed}, start epoch "
              f"{trainer.start_epoch} of {payload['extra']}, state equal "
              f"{equal}")
        images, labels = next(iter(trainer.train_loader))
        trainer.steps.plain(trainer.state, torch.from_numpy(images).to(dev),
                            torch.from_numpy(np.asarray(labels,
                                                        np.int64)).to(dev))
        check(trainer.state.step == flushed + 1,
              f"one step from {flushed} made {trainer.state.step}")
        trainer.state.model.load_state_dict(payload["model"])
        trainer.state.optimizer.load_state_dict(payload["optimizer"])
        trainer.state.step = flushed
        per_epoch = len(trainer.train_loader)
        with contextlib.redirect_stdout(open(os.path.join(
                out_dir, "resume.txt"), "a")):
            trainer.fit(trainer.start_epoch + 2)
        kept = trainer.ckpt.all_steps()
    finally:
        trainer.close()
        signal.signal(signal.SIGTERM, previous)
    want_kept = [flushed + per_epoch, flushed + 2 * per_epoch]
    check(kept == want_kept, f"kept steps {kept}, expected {want_kept}")
    # (c)
    ck = OrbaxCheckpointer(os.path.join(tmp, "flagship"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, flagship_state)
    blocking_ms = (time.perf_counter() - t0) * 1e3
    ck.wait_until_finished()
    total_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(os.path.join(tmp, "flagship", "1", "state.pt"))
    # (d)
    from cnsn_tpu_torch.segmentation.trainer import SegTrainer
    seg, _ = _seg_trainer(dev, SEG_RECIPE, 1, os.path.join(tmp, "seg"),
                          ckpt_backend="orbax", epochs=1)
    try:
        seg.train_epoch(0)
        seg.save_checkpoint(1)
        seg.ckpt.wait_until_finished()
        seg_step = seg.state.step
        want_sd = {k: v.detach().cpu() for k, v in
                   seg.state.model.state_dict().items()}
    finally:
        seg.close()
        signal.signal(signal.SIGTERM, previous)
    seg2 = SegTrainer(seg.cfg, seg.train_loader.dataset, device=dev)
    try:
        got_sd = seg2.state.model.state_dict()
        seg_equal = all(torch.equal(got_sd[k].cpu(), v)
                        for k, v in want_sd.items())
        check(seg2.state.step == seg_step == 1 and seg2.cfg.start_epoch == 1
              and seg_equal, f"SegTrainer orbax restore: step "
              f"{seg2.state.step} of {seg_step}, equal {seg_equal}")
    finally:
        seg2.close()
        signal.signal(signal.SIGTERM, previous)
    del seg, seg2
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "ckpt_preempt", "recipe": os.path.relpath(recipe, ROOT),
          "cli_exit": p.returncode, "steps_seen": seen,
          "flushed_step": flushed, "processes_left": left,
          "restored_step": restored_step, "state_equal_to_files": equal,
          "kept_after_two_epochs": kept, "steps_per_epoch": per_epoch,
          "flagship_async_save": {"blocking_ms": blocking_ms,
                                  "write_total_ms": total_ms,
                                  "bytes": nbytes,
                                  "step_ms": flagship_ms},
          "seg_restored_step": seg_step, "seg_state_equal": seg_equal,
          "card": nvidia_smi_name_power()})


def phase_nan_guard(dev):
    """``checked(trainer.steps.plain)`` (``utils/debug.py``) on WRN-40-2
    cnsn.yaml at b=128 32² bf16 from a Trainer's state, under cuDNN's
    deterministic algorithms: two unwrapped steps from the same state
    (their spread), a wrapped one equal to the first bit for bit (within
    the spread), then a NaN pixel raising with an op named; ms a step
    wrapped and not."""
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.train.trainer import Trainer
    from cnsn_tpu_torch.utils.debug import NonFiniteError, checked
    cfg = load_config(WRN_CN_RECIPES[1], synthetic_data=True,
                      compute_dtype="bf16", snapshot=False,
                      exp_dir=tempfile.mkdtemp(prefix="nan_"))
    with env_vars(CNSN_CONV3X3="conv"):
        trainer = Trainer(cfg, device=dev)
    images, labels = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).to(dev)
    labels = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    state = trainer.state
    start = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    plain, guarded = trainer.steps.plain, checked(trainer.steps.plain)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results = []
        for fn in (plain, plain, guarded):
            state.model.load_state_dict(start)
            state.optimizer.state.clear()
            state.step = 0
            _, m = fn(state, images, labels)
            torch.cuda.synchronize()
            results.append((float(m["loss"]),
                            {k: v.detach().clone() for k, v in
                             state.model.state_dict().items()}))
        spread = max(float((results[1][1][k].double()
                            - results[0][1][k].double()).abs().max())
                     for k in start if start[k].is_floating_point())
        err = max(float((results[2][1][k].double()
                         - results[0][1][k].double()).abs().max())
                  for k in start if start[k].is_floating_point())
        check(err <= spread,
              f"guarded step off by {err} (unwrapped spread {spread})")
        times = {}
        for name, fn in (("unwrapped", plain), ("guarded", guarded)):
            fn(state, images, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GUARD_STEPS):
                _, m = fn(state, images, labels)
            float(m["loss"])
            times[name] = (time.perf_counter() - t0) * 1e3 / GUARD_STEPS
        bad = images.clone()
        bad[5, 7, 9, 1] = float("nan")
        op = None
        try:
            guarded(state, bad, labels)
        except NonFiniteError as e:
            op = e.op
        check(op is not None, "a NaN pixel did not raise")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        trainer.close()
    emit({"phase": "nan_guard", "recipe": os.path.relpath(WRN_CN_RECIPES[1],
                                                          ROOT),
          "batch": cfg.batch_size, "dtype": "bfloat16",
          "clean_equal_bits": err == 0, "clean_max_abs_diff": err,
          "unwrapped_spread": spread, "nan_raised_by": op,
          "ms_per_step": times,
          "guard_over_unwrapped": times["guarded"] / times["unwrapped"],
          "card": nvidia_smi_name_power()})
    del trainer, state
    torch.cuda.empty_cache()


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
    cifar_rows = timed("kernel_vs_plain_cifar", phase_kernel_vs_plain_cifar,
                       dev, flush)
    densenet_k4 = timed("densenet_k4_vs_cudnn", phase_densenet_k4_vs_cudnn,
                        dev, flush)
    seg_rows = timed("seg_kernels_vs_plain", phase_seg_kernels_vs_plain,
                     dev, flush)
    psp_rows = timed("psp_kernels_vs_plain", phase_psp_kernels_vs_plain,
                     dev, flush)
    del flush
    torch.cuda.empty_cache()
    with env_vars(CNSN_CONV3X3="conv"):
        timed("train_card_vs_cpu", phase_train_card_vs_cpu, dev)
        timed("train_card_vs_cpu_seeds", phase_train_card_vs_cpu_seeds, dev)
        train_counts, n_cn, flagship_ms = timed("train", phase_train, dev)
    flagship_k4 = timed("train_flagship_k4", phase_train_flagship_k4, dev,
                        flagship_ms, k4_rows)
    timed("wrn_k4_vs_cudnn", phase_wrn_k4_vs_cudnn, dev)
    wrn_counts = timed("train_wrn", phase_train_wrn, dev)
    with env_vars(CNSN_CONV3X3="conv"):
        timed("cn_card_vs_cpu", phase_cn_card_vs_cpu, dev)
    cn_counts, cn_ms = timed("train_wrn_cn", phase_train_wrn_cn, dev)
    trainer_counts = timed("trainer_wrn", phase_trainer_wrn, dev,
                           cn_ms["cnsn.yaml"], cn_counts["cnsn.yaml"])
    cifar = timed("train_cifar_models", phase_train_cifar_models, dev)
    with env_vars(CNSN_CONV3X3="conv"):
        timed("consist_card_vs_cpu", phase_consist_card_vs_cpu, dev)
    timed("trainer_cifar", phase_trainer_cifar, dev)
    with env_vars(CNSN_CONV3X3="conv"):
        cn_counts["resnet50/cn.yaml"] = timed(
            "train_resnet_cn_both", phase_train_resnet_cn_both, dev)
        r50_consist = timed("train_resnet_consist",
                            phase_train_resnet_consist, dev)
        # rematerialised blocks against the same steps without, step
        # checkpoints with the SIGTERM flush, the NaN guard
        remat_paths, _, flag_state = timed(
            "remat_card_vs_card", phase_remat_card_vs_card, dev)
        timed("ckpt_preempt", phase_ckpt_preempt, dev, flag_state,
              flagship_ms)
        del flag_state
        torch.cuda.empty_cache()
        timed("nan_guard", phase_nan_guard, dev)
    # this slice: the ImageNet loaders and Trainer, ResNet-50-IBN-b's and
    # the CIFAR AugMix recipes, on folders written here
    with tempfile.TemporaryDirectory() as fake:
        data_dir, corrupt_dir, loaders = timed(
            "imagenet_loader", phase_imagenet_loader, fake)
        imagenet_counts = timed(
            "trainer_imagenet", phase_trainer_imagenet, dev, data_dir,
            corrupt_dir, flagship_ms,
            next(iter(loaders.values()))["ms_per_batch_mean"])
        ibn_counts_, _, ibn_step_ms = timed(
            "train_resnet_ibn_augmix", phase_train_resnet_ibn_augmix, dev,
            data_dir)
        cifar_augmix, cifar_augmix_ms = timed(
            "train_cifar_augmix", phase_train_cifar_augmix, dev)
        # on-device AugMix and the normalisation options
        timed("augmix_device_vs_cpu", phase_augmix_device_vs_cpu, dev,
              loaders[f"train_augmix_b{IBN_BATCH}_procs{os.cpu_count() - 1}"][
                  "ms_per_batch_mean_after_first"])
        ondevice = timed("train_ondevice_augmix",
                         phase_train_ondevice_augmix, dev, data_dir,
                         cifar_augmix_ms["wideresnet"], ibn_step_ms)
        remat_paths["resnet50_ibn_b_b256"] = timed(
            "train_remat_ibn", phase_train_remat_ibn, dev, data_dir,
            ibn_step_ms)
    with env_vars(CNSN_CONV3X3="conv"):
        timed("augmix_card_vs_cpu", phase_augmix_card_vs_cpu, dev)
    bn_options = timed("bn_options_card_vs_cpu",
                       phase_bn_options_card_vs_cpu, dev)
    # this slice: GTAV -> Cityscapes segmentation, FCN-ResNet50 (+ CNSN)
    seg_counts = timed("train_seg", phase_train_seg, dev)
    for key, per in timed("train_remat_seg", phase_train_remat_seg, dev,
                          seg_counts).items():
        remat_paths[f"seg_remat_{key}"] = per
    seg_eval = timed("seg_eval", phase_seg_eval, dev)
    # this slice: PSPNet, PSANet and PSALite on the same recipe, served
    psp_counts = timed("train_psp", phase_train_psp, dev)
    psa_counts = timed("train_psa", phase_train_psa, dev)
    psp_export = timed("seg_export", phase_seg_export, dev)
    with env_vars(CNSN_CONV3X3="conv"):
        timed("seg_card_vs_cpu", phase_seg_card_vs_cpu, dev)
    timed("seg_cli", phase_seg_cli, dev)
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
    # The v1 kernel's main path is DenseNet-40-12's eval (its SelfNorm
    # sites whose C is not a multiple of 8): its launches in one b=128 eval
    # step, its times at those sites at b=128; beside them, its time at the
    # serving forward's 16 sites through the forced path
    v1_eval = cifar["cifar10/densenet/cnsn.yaml"]["eval"].get(K3_V1, 0)
    dn_v1 = [r for r in cifar_rows if r["model"] == "densenet_eval_b128"]
    check(v1_eval > 0 and len(dn_v1) == v1_eval,
          f"K3 v1: {v1_eval} launches in DenseNet's eval, {len(dn_v1)} "
          "sites timed")
    k3_v1 = {"name": K3_V1, **k3_source, "launches": v1_eval,
             "max_abs_err": max(r["max_abs_err"] for r in dn_v1),
             **{out: sum(r[key] for r in dn_v1) for key, out in (
                 ("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                 ("bound_ms", "bound_ms"))},
             "per": f"DenseNet-40-12 cnsn.yaml eval step, b=128 bf16: its "
                    f"{len(dn_v1)} SelfNorm sites whose C is not a multiple "
                    "of 8 (phase train_cifar_models)",
             "resnet50_serving_forced": {
                 "ms": per_forward(BATCH, "v1_ms"),
                 "plain_ms": per_forward(BATCH, "plain_ms"),
                 "bound_ms": per_forward(BATCH, "bound_ms"),
                 "max_abs_err": max(r["v1_max_abs_err"] for r in k3_rows),
                 "per": f"b={BATCH} bf16 serving forward's {SN_SITES} "
                        "sites, forced path"}}
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
    # The wmma kernel's main path is DenseNet-40-12's training step under
    # pallas (35 sites, Cin 36…444 → 12; phase densenet_k4_vs_cudnn times
    # each site): its line holds that step, with its launches over
    # train_cifar_models' cnsn.yaml run; beside it, its time at WRN's 13
    # narrow sites through the forced path, and its fp32 rows
    narrow = [r for r in wrn_bf16 if r["kernel"] == K4_NARROW]
    fp32 = [r for r in k4_rows if r["dtype"] == "float32"]
    check(wrn_counts.get(K4_WMMA, 0) == 0 and all(
        r["kernel"] == K4_WMMA for r in fp32), "K4 wmma kernel's rows")
    dn = densenet_k4["wmma"]
    dn_run = cifar["cifar10/densenet/cnsn.yaml"]
    kernels.append({
        "name": K4_WMMA, "route": "cuda", "source": k4_source,
        "replaces": "cnsn_tpu/ops/pallas/conv_wgrad.py:197",
        "launches": dn_run["train"].get(K4_WMMA, 0),
        "max_abs_err": max([r["wmma_max_abs_err"] for r in narrow]
                           + [r["max_abs_err"] for r in fp32]
                           + [r["max_abs_err"] for r in cifar_rows
                              if r["kernel"] == K4_WMMA]),
        "ms": dn["kernel_ms"], "plain_ms": dn["plain_ms"],
        "bound_ms": dn["bound_ms"], "library_ms": dn["library_ms"],
        "bound_by": "bytes", "sites": dn["sites"],
        "per": "DenseNet-40-12 cnsn.yaml b=128 bf16 train forward's "
               "backward, CNSN_CONV3X3=pallas (launches: "
               f"{dn_run['steps']} steps of train_cifar_models)",
        "wrn_narrow_sites_forced": {
            out: sum(r[key] * r["sites"] for r in narrow)
            for key, out in (("wmma_ms", "ms"), ("plain_ms", "plain_ms"),
                             ("bound_ms", "bound_ms"),
                             ("library_ms", "library_ms"))},
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
    # each kernel's launches on the paths of this slice (train_cifar_models'
    # recipes and their eval steps; resnet50/cnsn-consist.yaml) and its
    # rows at their new shapes (per call)
    for k in [k3, k3_v1] + kernels:
        k["cifar_models"] = {
            name: {"train": run["train"].get(k["name"], 0),
                   "eval": run["eval"].get(k["name"], 0),
                   "steps": run["steps"]} for name, run in cifar.items()}
        k["resnet50_cnsn_consist"] = r50_consist.get(k["name"], 0)
        # the ImageNet and AugMix paths: cli train of resnet50/cnsn.yaml on
        # the fake folder (10 steps and an eval), the IBN-b AugMix step
        # loop (35 steps), the CIFAR AugMix step loops (35 steps each)
        k["imagenet_augmix_paths"] = {
            "imagenet_cli_train": imagenet_counts.get(k["name"], 0),
            "resnet50_ibn_b_augmix": ibn_counts_.get(k["name"], 0),
            "cifar_augmix": {m: c.get(k["name"], 0)
                             for m, c in cifar_augmix.items()}}
        k["new_shapes"] = [
            {key: r[key] for key in ("shape", "model", "kernel_ms",
                                     "plain_ms", "bound_ms", "library_ms",
                                     "max_abs_err")}
            for r in cifar_rows if r["kernel"] == k["name"]]
    # each kernel on the segmentation path (gtav_fcn50_cnsn.yaml, b=16 713²
    # float32): its time per plain training step from its rows at the
    # recipe's shapes by their sites (K3: per eval batch of 8), its
    # launches per plain and aug step (per eval batch), and in this run
    for k in [k3, k3_v1] + kernels:
        part = [r for r in seg_rows if r["kernel"] == k["name"]]
        seg = {key: (None if not part or part[0][key] is None else
                     sum(r[key] * r["sites"] for r in part))
               for key in ("kernel_ms", "plain_ms", "bound_ms",
                           "library_ms")}
        if k["name"] in (K3_STAGED, K3_V1):
            seg["launches_per_eval_batch"] = seg_eval[
                "launches_per_batch"].get(k["name"], 0)
            seg["per"] = "gtav_fcn50_cnsn.yaml eval batch of 8, float32"
        else:
            seg.update({kind: seg_counts[kind].get(k["name"], 0)
                        for kind in ("plain", "aug", "base")})
            seg["run_launches"] = seg_counts["run"].get(k["name"], 0)
            seg["run_steps"] = seg_counts["steps"]
            seg["per"] = ("gtav_fcn50_cnsn.yaml plain training step, b=16 "
                          "713² float32 (aug: + one K1 call at a SelfNorm "
                          "site's shape; base: gtav_fcn50.yaml)")
            if part and k["name"].startswith("ins_stats"):
                seg["aug_extra_mean_ms"] = (
                    sum(r["kernel_ms"] * r["sites"] for r in part)
                    / sum(r["sites"] for r in part))
        seg["shapes"] = len(part)  # each a seg_kernels_vs_plain line
        k["seg"] = seg
        # the PSP family on the same recipe: PSPNet's step is the FCN's
        # shapes and the PPM's bins (K2; K1 and K3 as the FCN's), each
        # timed at its sites in fp32; launches per step and in this run
        # (train_psp's epoch; train_psa's two steps alone and two warm);
        # K3 in the exported PSPNet's forward at each served batch: its
        # launches, and its rows at the 16 sites' shapes by their sites
        if k["name"] in (K3_STAGED, K3_V1):
            served = [r for r in psp_rows if r["kernel"] == k["name"]
                      and r["model"] == "psp_served"]
            k["seg_psp"] = {
                b: {"launches": psp_export[b]["launches"].get(k["name"], 0),
                    **{key: sum(r[key] * r["sites"] for r in served
                                if r["shape"][0] == b)
                       for key in ("kernel_ms", "plain_ms", "bound_ms")
                       if served},
                    "max_abs_err": max((r["max_abs_err"] for r in served
                                        if r["shape"][0] == b),
                                       default=None)}
                for b in PSP_SERVED}
            k["seg_psp"]["per"] = ("exported PSPNet-CNSN forward at b, 713², "
                                   "float32 (times: psp_kernels_vs_plain)")
            continue
        ppm = [r for r in psp_rows if r["kernel"] == k["name"]
               and r["model"] == "psp_ppm" and r["dtype"] == "float32"]
        psp = {key: (None if seg[key] is None else seg[key] + sum(
            r[key] * r["sites"] for r in ppm)) for key in (
                "kernel_ms", "plain_ms", "bound_ms", "library_ms")}
        psp.update({kind: psp_counts[kind].get(k["name"], 0)
                    for kind in ("plain", "aug")})
        psp["run_launches"] = psp_counts["run"].get(k["name"], 0)
        psp["run_steps"] = psp_counts["steps"]
        psp["psa_launches"] = {
            a: {"plain": c["plain"].get(k["name"], 0),
                "aug": c["aug"].get(k["name"], 0),
                "run": c["run"].get(k["name"], 0)}
            for a, c in psa_counts.items()}
        psp["per"] = ("gtav_fcn50_cnsn.yaml arch=psp plain training step, "
                      "b=16 713² float32")
        psp["new_shapes"] = [
            {key: r[key] for key in ("shape", "dtype", "model", "sites",
                                     "kernel_ms", "plain_ms", "bound_ms",
                                     "library_ms", "max_abs_err")}
            for r in psp_rows if r["kernel"] == k["name"]]
        k["seg_psp"] = psp
    # each kernel's launches in the first measured step of each kind of
    # the on-device AugMix Trainers (every step held to the host AugMix
    # path's counts in train_ondevice_augmix) and in their timed epochs
    # (read from the counters, equal to the steps' sum); per WRN-40-2
    # sn.yaml step under each BatchNorm option (none for CNSN_BN_VAR=two
    # and CNSN_BN_GROUPS=2, plain torch in both packages); K2 at the
    # stats_sample slices: its rows by their sites, per step
    for k in [k3, k3_v1] + kernels:
        name = k["name"]
        k["ondevice_augmix"] = {
            part: {"per_step": {
                kind: c.get(name, 0) for kind, c in
                ondevice[part]["ondevice"]["first_per_step"].items()},
                   "epoch": ondevice[part]["ondevice"]["launches"].get(
                       name, 0),
                   "steps": ondevice[part]["ondevice"]["steps"]}
            for part in ("cifar", "ibn")}
        k["ondevice_augmix"]["ibn_cli_train"] = ondevice["ibn"]["cli"].get(
            name, 0)
        k["ondevice_augmix"]["per"] = (
            "cifar: WRN-40-2 cnsn-augmix.yaml b=128 bf16, pallas; ibn: "
            f"ResNet-50-IBN-b cnsn-augmix.yaml b={IBN_BATCH} bf16 (Trainer "
            "epochs of train_ondevice_augmix)")
        k["bn_options"] = {variant: c.get(name, 0) for variant, c in
                           bn_options["wrn_sn"].items()}
        part = [r for r in bn_options["k2_rows"] if r["kernel"] == name]
        if part:
            k["stats_sample"] = {
                **{key: sum(r[key] * r["sites"] for r in part)
                   for key in ("kernel_ms", "plain_ms", "bound_ms")},
                "library_ms": (None if part[0]["library_ms"] is None else
                               sum(r["library_ms"] * r["sites"]
                                   for r in part)),
                "max_abs_err": max(r["max_abs_err"] for r in part),
                "per": f"WRN-40-2 sn.yaml training step, b=128 bf16, "
                       f"stats_sample={BN_SAMPLE}: K2 on the leading rows"}
    # each kernel's launches per step on the remat paths (every
    # bottleneck, or the listed stages, rematerialised): by path and
    # step kind
    for k in [k3, k3_v1] + kernels:
        k["remat"] = {path: {kind: c.get(k["name"], 0)
                             for kind, c in per.items()}
                      for path, per in remat_paths.items()}
        k["remat"]["per"] = (
            "one step of each kind: flagship b=128 and IBN-b b=192 "
            "(remat_card_vs_card), IBN-b b=256 (train_remat), "
            "gtav_fcn50_cnsn.yaml b=16 713² float32 (train_remat)")
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "seconds_by_phase": seconds})
    # compact: the line carries every kernel's paths and stays one line
    print(json.dumps({"kernels": [k3, k3_v1] + kernels},
                     separators=(",", ":")), flush=True)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
