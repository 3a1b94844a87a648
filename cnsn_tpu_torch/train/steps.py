"""Train and eval steps: port of ``cnsn_tpu/train/steps.py`` for the
flagship ImageNet recipe (``configs/imagenet/resnet50/cnsn.yaml``):
``StepFns.plain`` and ``StepFns.cn_image``, chosen per batch by the host
Bernoulli gate ``np.random.RandomState(seed).rand() < cn_prob``.

PyTorch runs eagerly, so where JAX jits a pure function of the state, a
step here updates the state in place (parameters, momentum buffers,
running statistics, update count) and returns it with its metrics.  The
metrics are device tensors: nothing in a step waits for the device.

The optimizer is ``torch.optim.SGD(momentum, dampening=0, weight_decay,
nesterov)``, which is the JAX package's ``make_sgd``
(``optax.add_decayed_weights`` then ``optax.sgd``): decay is added to
every parameter's gradient (BN and SelfNorm's included) before the
momentum buffer, and update s runs at lr = schedule(s), counted from 0.

The other six regimes of the JAX package (cn, cn_consistency, augmix,
augmix_cn, cn_image_consist, cn_image_augmix) are not ported yet
(ROADMAP queue 1) and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.crossnorm import cross_norm_2ins
from ..utils.device import resolve_device
from .losses import cross_entropy, error_topk

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
    ``generator`` when None)."""
    if perm is None:
        device = generator.device if generator is not None else None
        perm = torch.randperm(cn_num, generator=generator, device=device)
    mask = torch.zeros(cn_num, dtype=torch.bool, device=perm.device)
    mask[perm[:active_num]] = True
    return mask


def _not_ported(regime: str):
    def step(*args, **kwargs):
        raise NotImplementedError(f"training regime {regime!r} is not yet "
                                  f"ported to cnsn_tpu_torch (ROADMAP queue 1)")
    return step


class StepFns:
    """The step functions of one knob set.  ``image_crop`` is the crop
    mode of image-space CrossNorm ('neither' is the one ported).  One
    card pairs instances over the whole batch: the per-shard pairing of
    data parallelism comes with the parallel slice (ROADMAP queue 1)."""

    cn = staticmethod(_not_ported("cn"))
    cn_consistency = staticmethod(_not_ported("cn_consistency"))
    augmix = staticmethod(_not_ported("augmix"))
    augmix_cn = staticmethod(_not_ported("augmix_cn"))
    cn_image_consist = staticmethod(_not_ported("cn_image_consist"))
    cn_image_augmix = staticmethod(_not_ported("cn_image_augmix"))

    def __init__(self, *, image_crop: str = "neither"):
        self.image_crop = image_crop

    def plain(self, state: TrainState, images: torch.Tensor,
              labels: torch.Tensor):
        """One SGD update on the cross-entropy of a train-mode forward.
        images: NHWC float32 (B, H, W, 3); labels: (B,) int."""
        model = state.model.train()
        logits = model(images)
        loss = cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        logits = logits.detach()
        return state, {"loss": loss.detach(),
                       "err1": error_topk(logits, labels, 1)}

    def cn_image(self, state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor, perm: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """Image-space CrossNorm on the input batch (no gradient flows
        into it), then the plain update.  ``perm`` pairs the instances;
        when None it is drawn from ``generator``."""
        with torch.no_grad():
            images = cross_norm_2ins(images, perm=perm, generator=generator,
                                     crop=self.image_crop)
        return self.plain(state, images, labels)

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
