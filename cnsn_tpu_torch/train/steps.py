"""Train and eval steps: port of ``cnsn_tpu/train/steps.py``:
``StepFns.plain``, ``StepFns.cn`` (in-network CrossNorm at a random
``active_num`` of the model's sites, the CIFAR ``cn`` regime),
``StepFns.cn_image`` (image-space CrossNorm at every crop mode, the
ImageNet regime), the consistency regimes ``StepFns.cn_consistency``
and ``StepFns.cn_image_consist`` (a clean and two CrossNorm forwards in
one graph, cross-entropy plus ``consist_wt`` times their JSD), each
chosen per batch against ``plain`` by the host Bernoulli gate
``np.random.RandomState(seed).rand() < cn_prob``; the AugMix regimes
``StepFns.augmix`` (one forward of the three views (clean, AugMix,
AugMix) as one 3B batch, cross-entropy plus ``jsd_wt`` times their JSD)
and, against it by the gate, ``StepFns.augmix_cn`` (two CrossNorm
forwards of the clean view after it, their JSD with the clean one
weighted ``consist_wt``) and ``StepFns.cn_image_augmix`` (image
CrossNorm over the whole 3B batch first); and the eval steps
``eval_step`` and ``eval_sum`` (the evaluation loop's).

PyTorch runs eagerly, so where JAX jits a pure function of the state, a
step here updates the state in place (parameters, momentum buffers,
running statistics, update count) and returns it with its metrics.  The
metrics are device tensors: nothing in a step waits for the device.  The
random draws of a CrossNorm step (the site mask, each site's partner
permutation and boxes) are made on the host from a CPU generator, or
passed in by the caller.  A consistency step's three forwards update the
running statistics in turn, in place: forward k's BatchNorm shift is the
running mean that forward k−1 left, which is JAX's s1 → s2 → s3; so do
an ``augmix_cn`` step's 3B forward and its two CrossNorm forwards.

The optimizer is ``torch.optim.SGD(momentum, dampening=0, weight_decay,
nesterov)``, which is the JAX package's ``make_sgd``
(``optax.add_decayed_weights`` then ``optax.sgd``): decay is added to
every parameter's gradient (BN and SelfNorm's included) before the
momentum buffer, and update s runs at lr = schedule(s), counted from 0.

A parameter that no forward reaches (ResNeXt's 'identity' SelfNorm where
a downsample overwrites its output) gets a zero gradient, so that its
weight decay and momentum run as optax runs them on JAX's zero gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.crossnorm import cross_norm_2ins
from ..parallel.distributed import global_rows, world
from ..parallel.mesh import average_gradients
from ..utils.device import resolve_device
from .losses import cross_entropy, error_topk, jsd_consistency, softmax_probs

__all__ = ["StepFns", "TrainState", "create_train_state", "sample_cn_mask"]


@dataclass
class TrainState:
    """What a train step reads and updates: the model (parameters and
    running statistics), its SGD optimizer (momentum buffers), the
    learning-rate schedule and the number of updates taken."""
    model: nn.Module
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: nn.Module, schedule: Callable[[int], float],
                       *, momentum: float = 0.9, weight_decay: float = 5e-4,
                       nesterov: bool = True,
                       device: str | torch.device = "cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU) in train mode and give it an SGD optimizer."""
    model = model.to(resolve_device(device)).train()
    optimizer = torch.optim.SGD(model.parameters(), lr=schedule(0),
                                momentum=momentum, dampening=0.0,
                                weight_decay=weight_decay, nesterov=nesterov)
    return TrainState(model, optimizer, schedule)


def sample_cn_mask(cn_num: int, active_num: int, *,
                   perm: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Boolean mask with exactly ``active_num`` of ``cn_num`` sites on:
    the first ``active_num`` entries of ``perm`` (drawn from
    ``generator`` when None), on perm's device (the host for a CPU
    generator, where the model reads it as site gates)."""
    if perm is None:
        device = generator.device if generator is not None else None
        perm = torch.randperm(cn_num, generator=generator, device=device)
    mask = torch.zeros(cn_num, dtype=torch.bool, device=perm.device)
    mask[perm[:active_num]] = True
    return mask


class StepFns:
    """The step functions of one knob set (``steps.py:70-96``):
    ``active_num`` CrossNorm sites on per ``cn`` step, of the model's
    ``cn_num``; ``consist_wt``, the JSD's weight in a consistency step
    and of the CrossNorm JSD in an ``augmix_cn`` step; ``image_crop`` and
    ``image_beta`` for image-space CrossNorm; ``jsd_wt``, the AugMix JSD's
    weight (the reference hard-codes 12: cifar.py:246, imagenet.py:373);
    ``num_groups``, the blocks of the global batch image-space CrossNorm
    pairs within (the data-parallel width; the in-network sites take
    theirs from the model).

    Across ranks (``parallel/``) each rank runs a step on its rows of the
    global batch, with the draws of the whole batch (every rank's
    generator seeded alike): the losses are the means over its rows, and
    averaging the gradients over the ranks gives the global batch's."""

    def __init__(self, *, active_num: int = 1, consist_wt: float = 0.0,
                 image_crop: str = "neither", image_beta: float = 1.0,
                 jsd_wt: float = 12.0, num_groups: int = 1):
        self.active_num = active_num
        self.consist_wt = consist_wt
        self.image_crop = image_crop
        self.image_beta = image_beta
        self.jsd_wt = jsd_wt
        self.num_groups = num_groups

    @staticmethod
    def _sgd(state: TrainState, loss: torch.Tensor) -> None:
        """Back-propagate ``loss`` and take one SGD update at
        lr = schedule(step); a parameter the loss does not reach gets a
        zero gradient (JAX's), not none.  Across ranks the gradients are
        averaged before the update (``parallel/mesh.py``)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        average_gradients(p for group in state.optimizer.param_groups
                          for p in group["params"])
        state.optimizer.step()
        state.step += 1

    def _update(self, state: TrainState, images: torch.Tensor,
                labels: torch.Tensor, **forward):
        """One SGD update on the cross-entropy of a train-mode forward,
        ``forward`` passed on to the model."""
        model = state.model.train()
        logits = model(images, **forward)
        loss = cross_entropy(logits, labels)
        self._sgd(state, loss)
        logits = logits.detach()
        return state, {"loss": loss.detach(),
                       "err1": error_topk(logits, labels, 1)}

    def _consistency(self, state: TrainState, labels: torch.Tensor,
                     forwards: Sequence[tuple]):
        """One SGD update on ce(clean) + consist_wt · JSD(clean, a1, a2)
        over three train-mode forwards in one graph (``steps.py:158-179``),
        ``forwards`` = [(images, model keyword arguments)] for the clean,
        the first and the second augmented forward, run in that order."""
        model = state.model.train()
        logits = [model(images, **kw) for images, kw in forwards]
        ce = cross_entropy(logits[0], labels)
        jsd = jsd_consistency(*(softmax_probs(t) for t in logits))
        loss = ce + self.consist_wt * jsd
        self._sgd(state, loss)
        return state, {"loss": loss.detach(), "ce": ce.detach(),
                       "jsd": jsd.detach(),
                       "err1": error_topk(logits[0].detach(), labels, 1)}

    def plain(self, state: TrainState, images: torch.Tensor,
              labels: torch.Tensor):
        """One SGD update on the cross-entropy of a train-mode forward.
        images: NHWC float32 (B, H, W, 3); labels: (B,) int."""
        return self._update(state, images, labels)

    def cn(self, state: TrainState, images: torch.Tensor,
           labels: torch.Tensor, mask: Optional[Sequence[bool]] = None,
           draws: Optional[Sequence[dict]] = None,
           generator: Optional[torch.Generator] = None):
        """In-network CrossNorm (``steps.py:142-156``): ``active_num`` of
        the model's ``cn_num`` sites on, then the plain update.  ``mask``
        (cn_num host bools) and ``draws`` (each site's perm and boxes,
        ``nn/cnsn.py::CrossNorm``) are drawn from ``generator`` (a CPU
        generator) when None."""
        if mask is None:
            mask = sample_cn_mask(state.model.cn_num, self.active_num,
                                  generator=generator)
        return self._update(state, images, labels, cn_active=mask,
                            cn_draws=draws, generator=generator)

    def cn_consistency(self, state: TrainState, images: torch.Tensor,
                       labels: torch.Tensor,
                       masks: Optional[Sequence[Sequence[bool]]] = None,
                       draws: Optional[Sequence[Sequence[dict]]] = None,
                       generator: Optional[torch.Generator] = None):
        """In-network CrossNorm consistency (``steps.py:158-179``): a clean
        forward (no site on), then one with ``masks[0]`` and one with
        ``masks[1]`` (``active_num`` of ``cn_num`` sites on each), their
        site draws ``draws[0]`` and ``draws[1]``; what is None is drawn
        from ``generator`` (a CPU generator), both masks first, as JAX
        draws them.  Metrics: loss, ce, jsd, err1 (of the clean logits)."""
        if masks is None:
            masks = [sample_cn_mask(state.model.cn_num, self.active_num,
                                    generator=generator) for _ in range(2)]
        draws = draws or (None, None)
        return self._consistency(state, labels, [
            (images, {}),
            *((images, dict(cn_active=m, cn_draws=d, generator=generator))
              for m, d in zip(masks, draws))])

    def cn_image(self, state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor, perm: Optional[torch.Tensor] = None,
                 style_box: Optional[Sequence[int]] = None,
                 content_box: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None):
        """Image-space CrossNorm on the input batch (``steps.py:225-240``;
        no gradient flows into it) at crop ``image_crop``, then the plain
        update.  ``perm`` pairs the instances and the boxes crop them;
        what is None is drawn from ``generator`` (the boxes need a CPU
        one)."""
        with torch.no_grad():
            images = cross_norm_2ins(
                images, crop=self.image_crop, beta=self.image_beta,
                num_groups=self.num_groups, perm=perm, style_box=style_box,
                content_box=content_box, generator=generator)
        return self.plain(state, images, labels)

    def cn_image_consist(self, state: TrainState, images: torch.Tensor,
                         labels: torch.Tensor,
                         draws: Optional[Sequence[dict]] = None,
                         generator: Optional[torch.Generator] = None):
        """Image-space CrossNorm consistency (``steps.py:241-262``): two
        CrossNorm draws of the input batch at crop ``image_crop`` (no
        gradient flows into them), ``draws[i]`` the keyword arguments of
        ``cross_norm_2ins`` (perm, style_box, content_box; the rest from
        ``generator``), then the clean and the two augmented forwards and
        the loss of ``cn_consistency``."""
        draws = draws or ({}, {})
        with torch.no_grad():
            augmented = [cross_norm_2ins(
                images, crop=self.image_crop, beta=self.image_beta,
                num_groups=self.num_groups,
                generator=generator, **d) for d in draws]
        return self._consistency(state, labels,
                                 [(images, {})] + [(a, {}) for a in augmented])

    def _augmix_update(self, state: TrainState, images_all: torch.Tensor,
                       labels: torch.Tensor, cn_forwards: Sequence[tuple] = ()):
        """One SGD update on ce(clean) + jsd_wt · JSD(clean, aug1, aug2)
        from one train-mode forward of ``images_all``, the 3B batch
        (clean, aug1, aug2) (``steps.py:181-222``), plus consist_wt · the
        JSD of the clean logits with those of the ``cn_forwards`` (two
        (images, model keyword arguments), run after it in order)."""
        model = state.model.train()
        b = labels.shape[0]
        logits = model(images_all)
        lc, l1, l2 = logits[:b], logits[b:2 * b], logits[2 * b:]
        ce = cross_entropy(lc, labels)
        p_clean = softmax_probs(lc)
        jsd = jsd_consistency(p_clean, softmax_probs(l1), softmax_probs(l2))
        loss = ce + self.jsd_wt * jsd
        if cn_forwards:
            cn = [softmax_probs(model(images, **kw))
                  for images, kw in cn_forwards]
            loss = loss + self.consist_wt * jsd_consistency(p_clean, *cn)
        self._sgd(state, loss)
        return state, {"loss": loss.detach(), "ce": ce.detach(),
                       "jsd": jsd.detach(),
                       "err1": error_topk(lc.detach(), labels, 1)}

    def augmix(self, state: TrainState, images3: torch.Tensor,
               labels: torch.Tensor):
        """AugMix (``steps.py:214-215``): images3 (3, B, H, W, C), the
        views (clean, aug1, aug2), run as one 3B batch.  Metrics: loss,
        ce, jsd (the views'), err1 (of the clean logits)."""
        return self._augmix_update(state, images3.flatten(0, 1), labels)

    def augmix_cn(self, state: TrainState, images3: torch.Tensor,
                  labels: torch.Tensor,
                  masks: Optional[Sequence[Sequence[bool]]] = None,
                  draws: Optional[Sequence[Sequence[dict]]] = None,
                  generator: Optional[torch.Generator] = None):
        """AugMix with in-network CrossNorm (``steps.py:181-218``): the
        AugMix forward, then two CrossNorm forwards of the clean view
        with ``masks[0]`` and ``masks[1]`` (``active_num`` of ``cn_num``
        sites on each), their site draws ``draws[0]`` and ``draws[1]``;
        what is None is drawn from ``generator`` (a CPU generator), both
        masks first.  The running statistics thread through the three
        forwards in place.  Metrics as ``augmix``'s."""
        if masks is None:
            masks = [sample_cn_mask(state.model.cn_num, self.active_num,
                                    generator=generator) for _ in range(2)]
        draws = draws or (None, None)
        return self._augmix_update(
            state, images3.flatten(0, 1), labels,
            [(images3[0], dict(cn_active=m, cn_draws=d, generator=generator))
             for m, d in zip(masks, draws)])

    def cn_image_augmix(self, state: TrainState, images3: torch.Tensor,
                        labels: torch.Tensor,
                        perm: Optional[torch.Tensor] = None,
                        style_box: Optional[Sequence[int]] = None,
                        content_box: Optional[Sequence[int]] = None,
                        generator: Optional[torch.Generator] = None):
        """AugMix with image-space CrossNorm (``steps.py:264-289``): one
        CrossNorm draw at crop ``image_crop`` over the whole 3B batch (no
        gradient flows into it; reference imagenet.py:357-358), ``perm``
        and the boxes as ``cn_image`` takes them, then ``augmix``'s
        update.  Across ranks the pairing is JAX's, within
        ``num_groups`` blocks of the flattened global 3B batch (view
        major), which interleave the ranks' rows: the partners'
        statistics are gathered from every rank (``rows``)."""
        rows = None
        if world() is not None:
            views, b = images3.shape[:2]
            n, start = global_rows(b)
            rows = (torch.arange(views)[:, None] * n + start
                    + torch.arange(b)).reshape(-1)
        with torch.no_grad():
            images_all = cross_norm_2ins(
                images3.flatten(0, 1), crop=self.image_crop,
                beta=self.image_beta, num_groups=self.num_groups, perm=perm,
                style_box=style_box, content_box=content_box, rows=rows,
                generator=generator)
        return self._augmix_update(state, images_all, labels)

    def eval_step(self, state: TrainState, images: torch.Tensor,
                  labels: torch.Tensor):
        """An eval-mode forward (running statistics, SelfNorm through K3):
        mean cross-entropy, the number of top-1 hits and the logits."""
        model = state.model.eval()
        with torch.no_grad():
            logits = model(images)
        return {"loss": cross_entropy(logits, labels),
                "correct": (logits.argmax(dim=-1) == labels).sum(),
                "logits": logits}

    def eval_sum(self, state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor):
        """The evaluation loop's step (``steps.py:299-316``): an eval-mode
        forward, rows whose label is below 0 are padding and left out.
        Returns device scalars only, no logits, so the caller adds them
        up on the device and waits for it once per loader: the mean
        cross-entropy of the valid rows (of the logits cast to fp32),
        their top-1 hits and their number."""
        model = state.model.eval()
        with torch.no_grad():
            logits = model(images)
        valid = labels >= 0
        logp = torch.log_softmax(
            logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
        ce = -logp.gather(-1, labels.clamp(min=0)[:, None].long())[:, 0]
        n = valid.sum()
        return {"loss": torch.where(valid, ce, 0.0).sum() / n.clamp(min=1),
                "correct": ((logits.argmax(dim=-1) == labels)
                            & valid).sum(),
                "n": n}
