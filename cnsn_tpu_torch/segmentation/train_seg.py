"""Segmentation training steps: port of ``cnsn_tpu/segmentation/
train_seg.py`` (reference segmentation/tool/train_cnsn.py).

  * loss = CE(main) + aux_weight·CE(aux), ``ignore_label`` masked
    (:317-321), by default as the class-major fused upsample + CE of
    ``upsample.py`` on the stride-8 logits (``CNSN_SEG_CE=matmul``), or on
    the upsampled logits (``CNSN_SEG_CE=resize``);
  * SGD with momentum, weight decay added to the gradient before the
    momentum buffer (optax's ``add_decayed_weights`` then ``trace``), the
    poly schedule evaluated at the update count before the update
    (optax's ``scale_by_schedule``), and 10× the learning rate on the head
    parameter groups, applied after the buffer as torch's per-group lr;
  * the aug step draws the CrossNorm site mask (``active_num`` of
    ``cn_num`` on), the pairings and boxes on the host, or takes them
    from the caller; the image CrossNorm, where there is one, is on at
    every aug step;
  * metrics as intersection/union/target histograms
    (util.py intersectionAndUnionGPU), left on the device.

A step updates the state in place (parameters, momentum buffers, running
statistics, update count) and returns it with its metrics, device
tensors: nothing in a step waits for the device.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel import distributed
from ..parallel.mesh import average_gradients
from ..train.schedules import poly_lr
from ..train.steps import TrainState, sample_cn_mask
from ..utils.device import resolve_device
from .upsample import upsample_argmax, upsample_nll_sum

__all__ = ["SegTrainState", "make_seg_optimizer", "SegStepFns",
           "masked_cross_entropy", "masked_nll_sum", "seg_metrics",
           "create_seg_train_state", "HEAD_PREFIXES"]

# a train state of the port: model, optimizer, schedule, update count
SegTrainState = TrainState

HEAD_PREFIXES = ("classifier", "aux_classifier", "ppm", "cls", "aux", "psa",
                 "psa_reduce", "psa_bn", "psa_attn")
CE_MODES = ("matmul", "resize")


def masked_nll_sum(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_label: int = 255):
    """(sum of the per-pixel NLL over the non-ignored pixels, their
    count): logits (..., K), labels (...) integers."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_label: int = 255) -> torch.Tensor:
    """Mean CE over the non-ignored pixels (torch CrossEntropyLoss
    ignore_index semantics)."""
    nll_sum, n_valid = masked_nll_sum(logits, labels, ignore_label)
    return nll_sum / n_valid.clamp(min=1)


def _hist(values: torch.Tensor, keep: torch.Tensor,
          num_classes: int) -> torch.Tensor:
    """Per-class counts of ``values`` where ``keep``, float32; a value
    outside [0, num_classes) counts nowhere (JAX's one_hot of it is 0).
    A fixed-size scatter: no wait for the device."""
    ok = keep & (values >= 0) & (values < num_classes)
    idx = torch.where(ok, values, num_classes).long()
    counts = torch.zeros(num_classes + 1, dtype=torch.int64,
                         device=values.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:num_classes].to(torch.float32)


def seg_metrics(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                ignore_label: int = 255):
    """(intersection, union, target_area) histograms, each (K,) float32
    (reference util.py intersectionAndUnionGPU)."""
    pred = pred.reshape(-1)
    target = target.reshape(-1)
    pred = torch.where(target == ignore_label,
                       torch.as_tensor(ignore_label, dtype=pred.dtype,
                                       device=pred.device), pred)
    match = pred == target
    inter = _hist(pred, match & (pred != ignore_label), num_classes)
    area_p = _hist(pred, pred != ignore_label, num_classes)
    area_t = _hist(target, target != ignore_label, num_classes)
    return inter, area_p + area_t - inter, area_t


def label_groups(model: nn.Module, head_prefixes: Sequence[str]):
    """(body, head) parameters, a parameter in the head when the first
    component of its name is one of ``head_prefixes``."""
    body, head = [], []
    for name, p in model.named_parameters():
        (head if name.split(".")[0] in head_prefixes else body).append(p)
    return body, head


def make_seg_optimizer(model: nn.Module, base_lr: float, max_iter: int,
                       power: float = 0.9, momentum: float = 0.9,
                       weight_decay: float = 1e-4,
                       head_prefixes: Tuple[str, ...] = HEAD_PREFIXES):
    """(SGD, poly schedule): two parameter groups, the head's with
    ``lr_scale`` 10; a step sets each group's lr to lr_scale·schedule(s)."""
    body, head = label_groups(model, head_prefixes)
    groups = [{"params": body, "lr_scale": 1.0},
              {"params": head, "lr_scale": 10.0}]
    optimizer = torch.optim.SGD([g for g in groups if g["params"]],
                                lr=base_lr, momentum=momentum,
                                dampening=0.0, weight_decay=weight_decay,
                                nesterov=False)
    return optimizer, poly_lr(base_lr, max_iter, power)


def create_seg_train_state(model: nn.Module, base_lr: float, max_iter: int,
                           power: float = 0.9, momentum: float = 0.9,
                           weight_decay: float = 1e-4,
                           device: str | torch.device = "cuda"
                           ) -> SegTrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU) in train mode, with the segmentation SGD."""
    model = model.to(resolve_device(device)).train()
    optimizer, schedule = make_seg_optimizer(model, base_lr, max_iter,
                                             power, momentum, weight_decay)
    return SegTrainState(model, optimizer, schedule)


class SegStepFns:
    """Train and eval steps of one FCN model (``train_seg.py:96-230``)."""

    def __init__(self, model: nn.Module, *, num_classes: int,
                 active_num: int = 1, aux_weight: float = 0.4,
                 ignore_label: int = 255, lowres_ce: Optional[bool] = None):
        self.num_classes = num_classes
        self.active_num = active_num
        self.aux_weight = aux_weight
        self.ignore_label = ignore_label
        self.cn_num = model.cn_num
        self.has_img_cn = model.has_img_cn
        if lowres_ce is None:
            mode = os.environ.get("CNSN_SEG_CE", "matmul")
            if mode not in CE_MODES:
                raise ValueError(f"CNSN_SEG_CE={mode!r}: one of {CE_MODES}")
            lowres_ce = mode == "matmul"
        self.lowres_ce = bool(lowres_ce)
        # FCN resizes half-pixel; the PSP/PSA heads align corners
        self.align_corners = bool(getattr(model, "UPSAMPLE_ALIGN_CORNERS",
                                          False))

    def _ce(self, logits, labels):
        """The mean CE over the valid pixels; across ranks this rank's
        share of the global batch's (its NLL sum over the global count,
        times the ranks: averaging the gradients gives the global
        mean's, as JAX's sharded step computes it)."""
        if self.lowres_ce:
            s, n = upsample_nll_sum(logits, labels, self.ignore_label,
                                    self.align_corners)
        else:
            s, n = masked_nll_sum(logits, labels, self.ignore_label)
        w = distributed.world()
        if w is None:
            return s / n.clamp(min=1)
        n = distributed.all_reduce_(n.clone(), "loss_count")
        return s * w.size / n.clamp(min=1)

    def _pred(self, logits, labels):
        if self.lowres_ce:
            return upsample_argmax(logits, labels.shape[1], labels.shape[2],
                                   self.align_corners)
        return logits.argmax(dim=-1)

    def _metrics(self, logits, labels):
        return seg_metrics(self._pred(logits, labels), labels,
                           self.num_classes, self.ignore_label)

    @staticmethod
    def _sgd(state: SegTrainState, loss: torch.Tensor) -> None:
        """Back-propagate ``loss``, one SGD update at lr_scale·schedule(s)
        per group; a parameter the loss does not reach gets a zero
        gradient (JAX's), not none."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = group["lr_scale"] * lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        average_gradients(p for group in state.optimizer.param_groups
                          for p in group["params"])
        state.optimizer.step()
        state.step += 1

    def _update(self, state, images, labels, **forward):
        model = state.model.train()
        out, aux = model(images, upsample=not self.lowres_ce, **forward)
        main = self._ce(out, labels)
        aux_loss = self._ce(aux, labels)
        loss = main + self.aux_weight * aux_loss
        self._sgd(state, loss)
        with torch.no_grad():
            inter, union, target = self._metrics(out.detach(), labels)
        return state, {"loss": loss.detach(), "main_loss": main.detach(),
                       "aux_loss": aux_loss.detach(), "intersection": inter,
                       "union": union, "target": target}

    def plain(self, state: SegTrainState, images: torch.Tensor,
              labels: torch.Tensor):
        """One SGD update on a train-mode forward, CrossNorm off.
        images: NHWC float (B, H, W, 3); labels: (B, H, W) integers."""
        return self._update(state, images, labels)

    def aug(self, state: SegTrainState, images: torch.Tensor,
            labels: torch.Tensor, mask: Optional[Sequence[bool]] = None,
            draws: Optional[Sequence[dict]] = None,
            img_draws: Optional[dict] = None,
            generator: Optional[torch.Generator] = None):
        """The CrossNorm forward (``train_seg.py:130-141``): ``active_num``
        of the ``cn_num`` sites on (``mask``, host bools), the image
        CrossNorm on where the model has one, then the plain update.  What
        is None (the mask, each site's draws ``draws``, the image site's
        ``img_draws``) is drawn from ``generator`` (a CPU generator), the
        mask first."""
        if mask is None and self.cn_num > 0:
            mask = sample_cn_mask(self.cn_num, self.active_num,
                                  generator=generator)
        return self._update(
            state, images, labels, cn_active=mask if self.cn_num else None,
            img_cn_active=True if self.has_img_cn else None,
            cn_draws=draws, img_cn_draws=img_draws, generator=generator)

    def _eval_logits(self, state, images):
        model = state.model.eval()
        with torch.no_grad():
            out, _ = model(images, upsample=not self.lowres_ce)
        return out

    def eval_step(self, state: SegTrainState, images: torch.Tensor,
                  labels: torch.Tensor):
        """An eval-mode forward: mean CE, the prediction and the
        histograms."""
        out = self._eval_logits(state, images)
        with torch.no_grad():
            pred = self._pred(out, labels)
            inter, union, target = seg_metrics(
                pred, labels, self.num_classes, self.ignore_label)
            loss = self._ce(out, labels)
        return {"loss": loss, "pred": pred, "intersection": inter,
                "union": union, "target": target}

    def eval_sum(self, state: SegTrainState, images: torch.Tensor,
                 labels: torch.Tensor):
        """The validation loop's step (``train_seg.py:212-230``): device
        sums only, so the loop adds them up on the device and waits once.
        Rows of padding carry all-``ignore_label`` labels and add nothing."""
        out = self._eval_logits(state, images)
        with torch.no_grad():
            if self.lowres_ce:
                nll_sum, n_valid = upsample_nll_sum(
                    out, labels, self.ignore_label, self.align_corners)
            else:
                nll_sum, n_valid = masked_nll_sum(out, labels,
                                                  self.ignore_label)
            inter, union, target = self._metrics(out, labels)
        return {"nll_sum": nll_sum, "valid_px": n_valid.to(torch.float32),
                "intersection": inter, "union": union, "target": target}
