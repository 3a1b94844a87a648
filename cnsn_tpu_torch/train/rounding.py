"""How far a float32 training run lies from its float64 twin, and where
the distance enters.

The run is three SGD steps (plain, cn_image with a fixed permutation,
plain) of a reduced-depth ResNet-50+SN (layers (1, 1, 1, 1), full widths,
b=4 64², 10 classes, SelfNorm at pos='post'), from seeded weights and
data, in any type on any device.

Two float32 runs of the same steps (the card's and the CPU's, say) round
differently, and wherever an activation lies within that rounding of 0 a
ReLU passes the gradient in one run and blocks it in the other: that
element's gradient then differs by its whole value, and later steps carry
the difference on.  So a float32 run is compared with a float64 run that
*replays its ReLU masks and max-pool choices* (``run_steps(replay=...)``):
both then compute the same piecewise-linear function, and what is left
between them is rounding alone.

Rounding alone is not small at step 3.  SelfNorm's BatchNorm1d
normalises over a batch of 4, whose variance can be a small difference of
large terms, so the last bits of the statistics below it come out
amplified, and not in proportion to their error: two float32 runs whose
BatchNorm sums differ only in the order of their fp32 additions can lie
10x apart from their twins at step 3.  ``--seeds`` reads that spread: for
each input seed, the card's run with K2 and with two other BatchNorm sums
(torch's own, and ``exact_bn_sums``), and the CPU's run, each against its
replaying twin; ``seed_bounds`` holds the card's run to a multiple of the
largest of the other three (``chip_smoke.py``'s
``train_card_vs_cpu_seeds``).

    python -m cnsn_tpu_torch.train.rounding [--device cuda|cpu]
    python -m cnsn_tpu_torch.train.rounding --seeds 3,0,1 [--baseline DIR]

``run_cn_step`` is the same kind of run for in-network CrossNorm: one
``cn`` step of a reduced WRN (depth 10, widen 2, pos 'post', b=8 32²)
with fixed draws (``CN_MASK``, ``cn_draws``), for the knob sets of
``CN_KNOBS``; its float32 runs are held to float64 twins that replay
their ReLU masks in the same way (``chip_smoke.py``'s ``cn_card_vs_cpu``).
``run_consist_step`` is one ``cn_consistency`` step (three forwards in one
graph) with fixed masks and draws, of the reduced WRN at
``cifar10/wideresnet/cnsn-consist.yaml``'s knobs and of a DenseNet of
depth 7 at ``cifar10/densenet/cnsn-consist.yaml``'s (``CONSIST``;
``chip_smoke.py``'s ``consist_card_vs_cpu``).  ``run_seg_step`` is one
segmentation aug step of an FCN-CNSN or a PSPNet (``arch``) of layers
(1, 1, 1, 1) at the GTAV recipe's knobs, with fixed draws
(``chip_smoke.py``'s ``seg_card_vs_cpu``); the PSP heads' ReLUs go
through ``fcn.py``'s ``F`` as the FCN heads' do.

The first prints one JSON line: for the float32 run on ``--device`` and
for the CPU's, the error against its replaying float64 twin, and, for
step 1 against a float64 run with its own masks, each module's forward
and gradient error from the loss back to the stem and the ReLU inputs
whose sign differs.  The second (on the card) prints one line per input
seed: each run's errors against its replaying twin, as ``compare_runs``
gives them; ``--baseline`` adds a run with the K2 forward built from an
earlier checkout's ``cnsn_tpu_torch/csrc`` (``utils/stats_sweep.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models import build_model
from ..models import densenet as _densenet
from ..models import resnet as _resnet
from ..models import resnet_ibn as _resnet_ibn
from ..models import wideresnet as _wideresnet
from ..models.densenet import DenseNet
from ..models.wideresnet import WideResNet
from ..ops.bbox import sample_bbox
from ..ops.crossnorm import grouped_permutation
from ..ops.kernels import bn_stats as _bn_stats
from ..ops.kernels.bn_stats import bn_sums_reference as _plain_sums
from ..segmentation import backbone as _seg_backbone
from ..segmentation import fcn as _seg_fcn
from ..segmentation import pspnet as _seg_psp
from ..segmentation.fcn import fcn_cnsn
from ..segmentation.train_seg import SegStepFns, create_seg_train_state
from ..utils.device import resolve_device
from .schedules import cosine_lr
from .steps import StepFns, create_train_state

__all__ = ["CN_KNOBS", "CN_MASK", "CONSIST", "KINDS", "Run", "WITNESSES",
           "cn_draws", "compare_runs", "compare_traces", "exact_bn_sums",
           "run_augmix_step", "run_cn_step", "run_consist_step",
           "run_seg_step", "run_steps", "seed_bounds", "seed_spread"]

KINDS = ("plain", "cn_image", "plain")
BATCH, SIZE, CLASSES = 4, 64, 10  # 64² leaves layer4 at 2x2
PERM = (2, 0, 3, 1)  # the cn_image step's partner of each instance
# the cn step: a WRN of one block per group (3 sites: 32², 16², 8²), sites
# 1 and 3 on, and the knob sets of cn.yaml, cnsn.yaml and the fused site
CN_BATCH, CN_SIZE = 8, 32
CN_MASK = (True, False, True)
CN_KNOBS = {"cn_neither": dict(cnsn_type="cn", crop="neither"),
            "cnsn_both": dict(cnsn_type="cnsn", crop="both"),
            "cnsn_style": dict(cnsn_type="cnsn", crop="style")}
# the cn_consistency step: (model module, model, its two site masks, its
# SGD) at each recipe's knobs and active_num, 3 sites each (32², 16², 8²)
CONSIST = {
    "wrn": (_wideresnet, lambda g: WideResNet(
        depth=10, widen_factor=2, num_classes=CLASSES, pos="post",
        cnsn_type="cnsn", crop="both", generator=g),
        ((True, False, True), (False, True, True)),
        dict(momentum=0.9, weight_decay=5e-4, nesterov=True)),
    "densenet": (_densenet, lambda g: DenseNet(
        depth=7, num_classes=CLASSES, pos="conv1_pre", cnsn_type="cnsn",
        crop="content", generator=g),
        ((False, True, False), (True, False, False)),
        dict(momentum=0.9, weight_decay=1e-4, nesterov=True))}
CONSIST_WT = 10.0
# the AugMix steps: augmix_cn of a WRN of depth 10 at cifar10/wideresnet/
# cnsn-augmix.yaml's knobs (CNSN post, crop 'style', 1 of 3 sites on a
# CrossNorm forward), b=8 32²; cn_image_augmix of ResNet-50-IBN-b at
# layers (1, 1, 1, 1) with the IBN-b recipe's SelfNorm at pos 'residual',
# image CrossNorm (crop 'neither') over the 3B = 12 instances, 64²
AUGMIX_MASKS = ((True, False, False), (False, False, True))
AUGMIX_PERM = (5, 9, 0, 7, 11, 2, 10, 4, 1, 8, 3, 6)
# the seg aug step: an FCN-CNSN of layers (1, 1, 1, 1) at the GTAV
# recipe's knobs (SelfNorm at 'residual', CrossNorm 'style' at 'post'),
# heads' dropout 0, 5 classes, b=4 at 65² (layer4 at 9²), site 2 of 4 on
SEG_BATCH, SEG_SIZE, SEG_CLASSES = 4, 65, 5
SEG_MASK = (False, True, False, False)


class _Tape:
    """Stands in for ``torch.nn.functional`` inside ``models/resnet.py``.
    Without ``replay`` it records every ReLU's mask and every max-pool's
    choice; with the record of another run it applies those instead."""

    def __init__(self, replay: Optional[list] = None):
        self.replay = replay
        self.record: list = []

    def _next(self):
        return self.replay[len(self.record)]

    def __getattr__(self, name):  # the rest of torch.nn.functional
        return getattr(F, name)

    def relu(self, x):
        if self.replay is None:
            self.record.append((x > 0).cpu())
            return F.relu(x)
        mask = self._next()
        self.record.append(mask)
        return x * mask.to(x.device, x.dtype)

    def max_pool2d(self, x, kernel, stride, padding):
        if self.replay is None:
            out, idx = F.max_pool2d(x, kernel, stride, padding,
                                    return_indices=True)
            self.record.append(idx.cpu())
            return out
        idx = self._next()
        self.record.append(idx)
        n, c = idx.shape[:2]
        out = x.reshape(n, c, -1).gather(
            2, idx.reshape(n, c, -1).to(x.device)).reshape(idx.shape)
        return out.contiguous(memory_format=torch.channels_last)


@dataclass
class Run:
    """One run of ``KINDS``: each step's loss, the state after steps 1
    and 3 (parameters, running statistics and ``momentum.``-prefixed
    momentum buffers, on the CPU in the run's type), the tape of ReLU
    masks and max-pool choices, and, traced, step 1's output and output
    gradient of every module."""
    losses: list
    states: dict
    tape: list
    trace: dict = field(default_factory=dict)


def _snapshot(state) -> dict:
    out = {k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    out.update({"momentum." + n: opt.state[p]["momentum_buffer"].detach()
                .cpu().clone() for n, p in state.model.named_parameters()})
    return out


def _trace_hooks(model, trace: dict) -> list:
    def hook(name):
        def record(module, inputs, out):
            trace[name] = [out.detach().cpu(), None]
            if out.requires_grad:
                out.register_hook(
                    lambda g: trace[name].__setitem__(1, g.detach().cpu()))
        return record
    return [m.register_forward_hook(hook(n))
            for n, m in model.named_modules() if n]


@contextlib.contextmanager
def _exact(model_module, tape: _Tape):
    """TF32 off, and the ReLUs and max-pools of the model defined in
    ``model_module`` taken through ``tape``, while the block runs."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model_module.F = tape
    try:
        yield
    finally:
        model_module.F = F
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags



@contextlib.contextmanager
def _patched_sums(sums: Optional[Callable]):
    """Where ``sums`` is given, it takes the place of K2's forward and of
    its plain version for the BatchNorm sums while the block runs."""
    saved = {k: getattr(_bn_stats, k)
             for k in ("bn_sums_reference", "bn_sums_cuda")}
    if sums is not None:
        for k in saved:
            setattr(_bn_stats, k, sums)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(_bn_stats, k, fn)

def exact_bn_sums(x: torch.Tensor, m0: torch.Tensor):
    """K2's sums correctly rounded: the float32 differences x − m0 and
    their rounded squares, as the kernel and the plain version form them,
    added in float64 and rounded once to float32, as the card's K2
    forward adds them (``csrc/bn_stats.cu``)."""
    d = x.float() - m0
    axes = tuple(range(x.dim() - 1))
    return (d.double().sum(dim=axes).float(),
            (d * d).double().sum(dim=axes).float())


def run_steps(device: str | torch.device, dtype: torch.dtype, *,
              replay: Optional[list] = None, trace: bool = False,
              seed: int = 3, sums: Optional[Callable] = None) -> Run:
    """The three steps on ``device`` (TF32 off) in ``dtype`` (float32 or
    float64, the whole model), on images and labels drawn from ``seed``.
    ``replay``: the tape of another run, whose ReLU masks and max-pool
    choices this run applies.  ``sums``: a function (x, m0) -> (s1, s2)
    that takes the place of K2's forward and of its plain version for
    this run's BatchNorm sums."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(len(KINDS), BATCH, SIZE, SIZE, 3, generator=gen)
    labels = torch.randint(0, CLASSES, (len(KINDS), BATCH), generator=gen)
    model = build_model("resnet50", CLASSES,
                        generator=torch.Generator().manual_seed(0),
                        layers=(1, 1, 1, 1), pos="post", cnsn_type="sn")
    state = create_train_state(model.to(dtype), cosine_lr(0.05, 4),
                               momentum=0.9, weight_decay=1e-4,
                               nesterov=False, device=device)
    steps, tape, traced = StepFns(), _Tape(replay), {}
    handles = _trace_hooks(state.model, traced) if trace else []
    losses, states = [], {}
    with _patched_sums(sums):
        with _exact(_resnet, tape):
            for i, kind in enumerate(KINDS):
                x = images[i].to(device, dtype)
                y = labels[i].to(device)
                if kind == "plain":
                    state, metrics = steps.plain(state, x, y)
                else:
                    state, metrics = steps.cn_image(
                        state, x, y, perm=torch.tensor(PERM, device=device))
                losses.append(float(metrics["loss"]))
                for h in handles:
                    h.remove()
                handles = []
                if i in (0, len(KINDS) - 1):
                    states[i + 1] = _snapshot(state)
    return Run(losses, states, tape.record, traced)


def cn_draws(seed: int = 0) -> list:
    """Fixed draws for the cn step's three sites, from a seeded CPU
    generator: each site's partner permutation, style box and content
    box (a crop uses what it needs)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for side in (CN_SIZE, CN_SIZE // 2, CN_SIZE // 4):
        out.append({"perm": grouped_permutation(CN_BATCH, 1, gen),
                    "style_box": sample_bbox(side, side, generator=gen),
                    "content_box": sample_bbox(side, side, generator=gen)})
    return out


def run_cn_step(device: str | torch.device, dtype: torch.dtype, knobs: str,
                *, replay: Optional[list] = None, seed: int = 3) -> Run:
    """One ``cn`` step (``StepFns.cn``, sites ``CN_MASK`` on, draws
    ``cn_draws()``) of the reduced WRN with the knobs ``CN_KNOBS[knobs]``
    on ``device`` (TF32 off) in ``dtype``, from seeded weights and data;
    ``replay``: another run's ReLU masks, applied.  The Run's state is
    the one after the step (key 1)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(CN_BATCH, CN_SIZE, CN_SIZE, 3, generator=gen)
    labels = torch.randint(0, CLASSES, (CN_BATCH,), generator=gen)
    model = WideResNet(depth=10, widen_factor=2, num_classes=CLASSES,
                       pos="post", generator=torch.Generator().manual_seed(0),
                       **CN_KNOBS[knobs])
    state = create_train_state(model.to(dtype), cosine_lr(0.1, 4),
                               momentum=0.9, weight_decay=5e-4,
                               nesterov=True, device=device)
    tape = _Tape(replay)
    with _exact(_wideresnet, tape):
        state, metrics = StepFns(active_num=sum(CN_MASK)).cn(
            state, images.to(device, dtype), labels.to(device),
            mask=CN_MASK, draws=cn_draws())
        loss = float(metrics["loss"])
    return Run([loss], {1: _snapshot(state)}, tape.record)


def run_consist_step(device: str | torch.device, dtype: torch.dtype,
                     model: str, *, replay: Optional[list] = None,
                     seed: int = 3, sums: Optional[Callable] = None) -> Run:
    """One ``cn_consistency`` step (a clean and two CrossNorm forwards,
    consist_wt 10, masks and draws fixed: ``CONSIST[model]``,
    ``cn_draws(0)`` and ``cn_draws(1)``) of ``model`` on ``device`` (TF32
    off) in ``dtype``, b=8 32², from seeded weights and data; ``replay``:
    another run's ReLU masks, applied; ``sums``: as in ``run_steps``.  The
    Run's state is the one after the step (key 1)."""
    device = resolve_device(device)
    module, build, masks, sgd = CONSIST[model]
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(CN_BATCH, CN_SIZE, CN_SIZE, 3, generator=gen)
    labels = torch.randint(0, CLASSES, (CN_BATCH,), generator=gen)
    net = build(torch.Generator().manual_seed(0))
    state = create_train_state(net.to(dtype), cosine_lr(0.1, 4),
                               device=device, **sgd)
    tape = _Tape(replay)
    with _patched_sums(sums):
        with _exact(module, tape):
            state, metrics = StepFns(consist_wt=CONSIST_WT).cn_consistency(
                state, images.to(device, dtype), labels.to(device),
                masks=masks, draws=(cn_draws(0), cn_draws(1)))
            loss = float(metrics["loss"])
    return Run([loss], {1: _snapshot(state)}, tape.record)


def run_augmix_step(device: str | torch.device, dtype: torch.dtype,
                    kind: str, *, replay: Optional[list] = None,
                    seed: int = 3, sums: Optional[Callable] = None) -> Run:
    """One AugMix step of ``kind``: 'augmix_cn' (``StepFns.augmix_cn``,
    masks ``AUGMIX_MASKS``, draws ``cn_draws(0)`` and ``cn_draws(1)``, on
    the reduced WRN) or 'cn_image_augmix' (perm ``AUGMIX_PERM``, on the
    reduced ResNet-50-IBN-b), on ``device`` (TF32 off) in ``dtype``, on
    seeded views (3, B, H, W, 3) and weights; ``replay`` and ``sums`` as
    in ``run_steps``.  The Run's state is the one after the step."""
    device = resolve_device(device)
    if kind == "augmix_cn":
        module, batch, size, sgd = _wideresnet, CN_BATCH, CN_SIZE, dict(
            momentum=0.9, weight_decay=5e-4, nesterov=True)
        net = WideResNet(depth=10, widen_factor=2, num_classes=CLASSES,
                         pos="post", cnsn_type="cnsn", crop="style",
                         generator=torch.Generator().manual_seed(0))
    elif kind == "cn_image_augmix":
        module, batch, size, sgd = _resnet_ibn, BATCH, SIZE, dict(
            momentum=0.9, weight_decay=1e-4, nesterov=False)
        net = build_model("resnet50_ibn_b", CLASSES,
                          generator=torch.Generator().manual_seed(0),
                          layers=(1, 1, 1, 1), pos="residual",
                          cnsn_type="sn")
    else:
        raise ValueError(f"unknown AugMix step {kind!r}")
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(3, batch, size, size, 3, generator=gen)
    labels = torch.randint(0, CLASSES, (batch,), generator=gen)
    state = create_train_state(net.to(dtype), cosine_lr(0.05, 4),
                               device=device, **sgd)
    steps = StepFns(active_num=1, consist_wt=CONSIST_WT)
    x, y = images.to(device, dtype), labels.to(device)
    tape = _Tape(replay)
    with _patched_sums(sums):
        with _exact(module, tape):
            if kind == "augmix_cn":
                state, metrics = steps.augmix_cn(
                    state, x, y, masks=AUGMIX_MASKS,
                    draws=(cn_draws(0), cn_draws(1)))
            else:
                state, metrics = steps.cn_image_augmix(
                    state, x, y, perm=torch.tensor(AUGMIX_PERM,
                                                   device=device))
            loss = float(metrics["loss"])
    return Run([loss], {1: _snapshot(state)}, tape.record)


@contextlib.contextmanager
def _exact_seg(tape: _Tape):
    """``_exact`` over both modules of the FCN (backbone and heads)."""
    with _exact(_seg_backbone, tape):
        _seg_fcn.F = tape
        try:
            yield
        finally:
            _seg_fcn.F = F


def run_seg_step(device: str | torch.device, dtype: torch.dtype, *,
                 replay: Optional[list] = None, seed: int = 3,
                 sums: Optional[Callable] = None,
                 arch: str = "fcn_cnsn") -> Run:
    """One segmentation aug step (``SegStepFns.aug``: site ``SEG_MASK``
    on, its partner permutation and style box fixed, the class-major
    fused CE, poly LR with 10× heads) of the reduced ``arch`` ('fcn_cnsn'
    or 'psp', the recipe's CNSN knobs, heads' dropout 0) on ``device``
    (TF32 off) in ``dtype``, on seeded images (labels with an ignored
    band) and weights; ``replay`` and ``sums`` as in ``run_steps``.  The
    Run's state is the one after the step."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(SEG_BATCH, SEG_SIZE, SEG_SIZE, 3, generator=gen)
    labels = torch.randint(0, SEG_CLASSES, (SEG_BATCH, SEG_SIZE, SEG_SIZE),
                           generator=gen)
    labels[:, :3] = 255
    module = _seg_psp if arch == "psp" else _seg_fcn
    full = module.seg_resnet50
    module.seg_resnet50 = functools.partial(_seg_backbone.SegResNet,
                                            layers=(1, 1, 1, 1))
    try:
        init = torch.Generator().manual_seed(0)
        if arch == "psp":
            net = _seg_psp.PSPNet(
                SEG_CLASSES, dropout=0.0, block_idxs="1_2_3_4",
                pos="residual", cn_pos="post", cnsn_type="cnsn",
                crop="style", generator=init)
        else:
            net = fcn_cnsn(SEG_CLASSES, dropout=0.0, generator=init)
    finally:
        module.seg_resnet50 = full
    state = create_seg_train_state(net.to(dtype), 0.01, 4, device=device)
    draws = [{"perm": grouped_permutation(SEG_BATCH, 1, gen),
              "style_box": sample_bbox(side, side, generator=gen)}
             for side in (33, 17, 9, 9)]
    steps = SegStepFns(net, num_classes=SEG_CLASSES)
    tape = _Tape(replay)
    with _patched_sums(sums):
        with _exact_seg(tape):
            state, metrics = steps.aug(
                state, images.to(device, dtype), labels.to(device),
                mask=SEG_MASK, draws=draws)
            loss = float(metrics["loss"])
    return Run([loss], {1: _snapshot(state)}, tape.record)


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    want = want.double()
    return (float((got.double() - want).abs().max())
            / max(float(want.abs().max()), 1e-30))


# a reference tensor below this max-abs holds float64 rounding alone: a
# BatchNorm bias whose output an InstanceNorm follows (IBN-b's bn3 and
# downsample before the post-add IN) gets a zero gradient, ~1e-18 after
# a step, so a relative error says nothing of it
NOISE = 1e-12


def compare_runs(run: Run, ref: Run) -> dict:
    """Errors of ``run`` against ``ref``: each step's loss (relative), and
    after steps 1 and 3 the worst tensor of the state and of the momentum
    buffers (each over that tensor's max-abs), with its name.  Tensors of
    ``ref`` whose max-abs is below ``NOISE`` are held apart, by their
    largest absolute error (``step<n>_<part>_at_zero``), so that a run
    which moves a tensor the reference leaves at zero still shows it."""
    out = {"loss_rel_err": [abs(a - b) / abs(b)
                            for a, b in zip(run.losses, ref.losses)]}
    for step, want in ref.states.items():
        got = run.states[step]
        for part, keep in (("state", lambda k: not k.startswith("momentum.")),
                           ("momentum", lambda k: k.startswith("momentum."))):
            rel, at_zero = [], []
            for k in filter(keep, want):
                if float(want[k].abs().max()) >= NOISE:
                    rel.append((_rel_max(got[k], want[k]), k))
                else:
                    at_zero.append((float(
                        (got[k].double() - want[k].double()).abs().max()), k))
            out[f"step{step}_{part}"] = max(rel)
            if at_zero:
                out[f"step{step}_{part}_at_zero"] = max(at_zero)
    return out


def _relu_input(name: str) -> bool:
    """Modules whose output goes into a ReLU: the stem's BN, each
    bottleneck's bn1 and bn2, and its SelfNorm (pos='post')."""
    return name == "bn1" or name.endswith((".bn1", ".bn2", ".cnsn"))


def compare_traces(run: Run, ref: Run) -> list:
    """Step 1, module by module from the loss back to the stem: the error
    of the output and of its gradient against ``ref``; at each ReLU input,
    the elements whose sign differs and the gradient's error over the
    other elements alone."""
    rows = []
    for name in reversed(list(ref.trace)):
        (out, grad), (want, want_g) = run.trace[name], ref.trace[name]
        row = {"module": name, "fwd_err": _rel_max(out, want)}
        if want_g is not None:
            row["grad_err"] = _rel_max(grad, want_g)
        if _relu_input(name) and want_g is not None:
            agree = (out > 0) == (want > 0)
            row["sign_flips"] = int((~agree).sum())
            scale = max(float(want_g.double().abs().max()), 1e-30)
            row["grad_err_where_signs_agree"] = float(
                ((grad.double() - want_g.double()) * agree).abs().max()) / scale
        rows.append(row)
    return rows


def seed_spread(seeds, baseline=None) -> list:
    """Per input seed, the float32 runs on the card (K2's sums, torch's,
    ``exact_bn_sums``, and a ``baseline`` K2 where given) and on the CPU,
    each against its replaying float64 twin (``compare_runs``)."""
    variants = {"card": ("cuda", None),
                "card_torch_sums": ("cuda", _plain_sums),
                "card_exact_bn_sums": ("cuda", exact_bn_sums),
                "cpu": ("cpu", None)}
    if baseline is not None:
        variants["card_baseline"] = ("cuda", baseline)
    rows = []
    for seed in seeds:
        row = {"seed": seed}
        for name, (device, sums) in variants.items():
            run = run_steps(device, torch.float32, seed=seed, sums=sums)
            row[name] = compare_runs(run, run_steps(
                "cpu", torch.float64, replay=run.tape, seed=seed))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


# The float32 runs of a seed_spread row that a card run is held against:
# the CPU's, and the card's with torch's and with exact BatchNorm sums
WITNESSES = ("cpu", "card_torch_sums", "card_exact_bn_sums")


def seed_bounds(row: dict, factor: float, floor: float) -> list:
    """Each quantity of the card's run in one ``seed_spread`` row (the loss of
    each step; after steps 1 and 3 the worst state and momentum tensor)
    beside its bound: ``factor`` times the largest error of the
    ``WITNESSES`` at that quantity, at least ``factor · floor``.  Returns
    [(quantity, error, bound)]; the run is within bound where every error
    is at most its bound."""
    out = []
    for key, got in row["card"].items():
        if key == "loss_rel_err":
            items = [(f"{key}[{i}]", g, [row[w][key][i] for w in WITNESSES])
                     for i, g in enumerate(got)]
        else:
            items = [(key, got[0], [row[w][key][0] for w in WITNESSES])]
        out += [(name, g, factor * max(max(refs), floor))
                for name, g, refs in items]
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seeds", help="comma-separated input seeds")
    parser.add_argument("--baseline", type=Path)
    args = parser.parse_args(argv)
    if args.seeds:
        base = None
        if args.baseline is not None:
            from ..utils.stats_sweep import _baseline
            base = _baseline(args.baseline)
        return seed_spread([int(s) for s in args.seeds.split(",")], base)
    devices = [resolve_device(args.device)]
    if devices[0].type != "cpu":
        devices.append(torch.device("cpu"))
    ref = run_steps("cpu", torch.float64, trace=True)
    result = {}
    for device in devices:
        run = run_steps(device, torch.float32, trace=True)
        twin = run_steps("cpu", torch.float64, replay=run.tape)
        result[f"{device.type}_f32"] = {
            "vs_replaying_f64": compare_runs(run, twin),
            "vs_own_f64": compare_runs(run, ref),
            "step1_by_module": compare_traces(run, ref)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
