"""Host-side training loop: port of ``cnsn_tpu/train/trainer.py`` for
the CIFAR datasets (reference mains: cifar.py:315-511).

A per-epoch loop over the host loader, its batches staged onto the card
ahead of the step (``utils/prefetch.py``); the stochastic CN gate
(``RandomState(seed).rand() < cn_prob``, cifar.py:127-128) picks the step
function per batch; the evaluation, ``log.txt`` and checkpoints mirror
the JAX package's layout.  It runs on the card unless the caller asks
for the CPU.  What the port does not have yet raises when the Trainer is
built (``NOT_PORTED``).
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.cifar import CifarLoader, load_cifar
from ..evaluation.classify import evaluate, evaluate_cifar_c
from ..models import build_model
from ..utils.checkpoint import restore_state, save_checkpoint
from ..utils.device import resolve_device
from ..utils.meters import AverageMeter, get_log_dir_path
from ..utils.prefetch import batch_put, device_prefetch
from .schedules import cosine_lr, imagenet_step_lr
from .steps import StepFns, create_train_state

__all__ = ["Trainer", "NOT_PORTED"]

DTYPES = {"fp32": None, "bf16": torch.bfloat16}

_AUGMIX = "ROADMAP queue 1, AugMix"
_PARALLEL = "ROADMAP queue 1, parallel"
# (what is set, the ROADMAP item that ports it), checked in this order
NOT_PORTED = (
    (lambda c: c.dataset == "imagenet", "dataset: imagenet",
     "ROADMAP queue 1, the ImageNet loaders"),
    (lambda c: c.ckpt_backend == "orbax", "ckpt_backend: orbax",
     "ROADMAP queue 1, the remaining utils"),
    (lambda c: c.fsdp, "fsdp", _PARALLEL),
    (lambda c: (c.num_devices or 1) > 1, "num_devices > 1", _PARALLEL),
    (lambda c: c.remat, "remat", _PARALLEL),
    (lambda c: c.ondevice_augmix, "ondevice_augmix", _AUGMIX),
    (lambda c: c.no_jsd, "no_jsd", _AUGMIX),
    (lambda c: "augmix" in c.regime, "an augmix regime", _AUGMIX),
)

# the regimes whose gated step is ported: regime → the StepFns method the
# gate picks, else plain (cnsn_tpu/train/trainer.py:259-278)
_GATED = {"plain": None, "cn": "cn", "cn_consistency": "cn_consistency",
          "cn_image": "cn_image", "cn_image_consist": "cn_image_consist"}


def _check_ported(cfg: ExperimentConfig) -> None:
    for is_set, what, item in NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{what} (regime {cfg.regime!r}) is not yet ported to "
                f"cnsn_tpu_torch ({item})")
    if cfg.regime not in _GATED:
        raise ValueError(cfg.regime)
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                         f"{sorted(DTYPES)}")


def _timed(iterable: Iterable, meter: AverageMeter) -> Iterator:
    """``iterable``'s items, the seconds spent waiting for each added to
    ``meter``."""
    it = iter(iterable)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            meter.update(time.perf_counter() - t0)
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class Trainer:
    def __init__(self, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg = cfg.infer()
        self.device = resolve_device(device)
        _check_ported(cfg)
        np.random.seed(cfg.seed)

        self.model = build_model(
            cfg.model, cfg.num_classes,
            generator=torch.Generator().manual_seed(cfg.seed), pos=cfg.pos,
            crop=cfg.crop, beta=cfg.beta, cnsn_type=cfg.cnsn_type,
            dtype=DTYPES[cfg.compute_dtype])

        self.train_data = load_cifar(cfg.data_dir, cfg.dataset, True,
                                     synthetic=cfg.synthetic_data)
        self.test_data = load_cifar(cfg.data_dir, cfg.dataset, False,
                                    synthetic=cfg.synthetic_data)
        self.train_loader = CifarLoader(self.train_data, cfg.batch_size,
                                        mode="train", seed=cfg.seed)
        self.test_loader = CifarLoader(self.test_data, cfg.eval_batch_size,
                                       mode="eval")

        steps_per_epoch = len(self.train_loader)
        if cfg.schedule == "cosine":
            sched = cosine_lr(cfg.lr, cfg.epochs * steps_per_epoch)
        elif cfg.schedule == "imagenet_step":
            sched = imagenet_step_lr(cfg.lr, cfg.epochs, cfg.batch_size,
                                     steps_per_epoch)
        else:
            raise ValueError(cfg.schedule)
        self.schedule = sched
        self.state = create_train_state(
            self.model, sched, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, nesterov=cfg.nesterov,
            device=self.device)
        if cfg.pretrained and os.path.isfile(cfg.pretrained):
            unmatched = self._load_pretrained(cfg.pretrained)
            print(f"loaded pretrained '{cfg.pretrained}' "
                  f"({unmatched} unmatched keys)")
        self.steps = StepFns(active_num=cfg.active_num or 1,
                             consist_wt=cfg.consist_wt or 0.0,
                             image_crop=cfg.crop or "neither",
                             image_beta=cfg.beta or 1.0)

        self.start_epoch = 0
        self.best_acc = 0.0
        if cfg.resume and os.path.isfile(cfg.resume):
            self.state, self.start_epoch, self.best_acc = restore_state(
                cfg.resume, self.state)
            self.exp_dir = os.path.dirname(cfg.resume)
            print(f"=> loaded checkpoint '{cfg.resume}' "
                  f"(epoch {self.start_epoch})")
        else:
            self.exp_dir = get_log_dir_path(cfg.exp_dir, cfg.exp_id)
            os.makedirs(self.exp_dir, exist_ok=True)
        self.log_file = os.path.join(self.exp_dir, "log.txt")
        if cfg.snapshot:
            # provenance snapshot (train_cnsn.sh: cp script+config into
            # the exp dir); the CLI adds the log tee
            from ..utils.provenance import snapshot_experiment
            snapshot_experiment(self.exp_dir, cfg, tee=False)
        self._rng = np.random.RandomState(cfg.seed)
        # CrossNorm's draws (site masks, pairings, boxes) on the host; the
        # JAX package folds the step index into key(seed + 7919): the same
        # distributions, other numbers
        self._draws = torch.Generator().manual_seed(cfg.seed + 7919)
        # seconds the step loop waited for each staged batch, last epoch
        self.data_wait = AverageMeter()

    def _load_pretrained(self, path: str) -> int:
        """A torch .pth (a bare state dict, or one under 'state_dict') into
        the model, strict=False as imagenet.py:518-521; returns the number
        of its keys that match no tensor of the model's shape."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(payload, dict) and "state_dict" in payload:
            payload = payload["state_dict"]
        own = self.state.model.state_dict()
        sd = {k.removeprefix("module."): v for k, v in payload.items()
              if not k.endswith("num_batches_tracked")}
        fit = {k: v for k, v in sd.items()
               if k in own and tuple(own[k].shape) == tuple(v.shape)}
        self.state.model.load_state_dict(fit, strict=False)
        return len(sd) - len(fit)

    # ---- one epoch -------------------------------------------------------

    def train_epoch(self) -> float:
        cfg = self.cfg
        losses = AverageMeter()
        self.data_wait.reset()
        # per-step losses stay on the device; resolving each at once would
        # make the host wait for every step
        pending = []
        staged = device_prefetch(self.train_loader, batch_put(self.device),
                                 depth=cfg.prefetch_depth)
        gated = _GATED[cfg.regime]
        for i, (im, lb) in enumerate(_timed(staged, self.data_wait)):
            gate = (cfg.cn_prob is not None
                    and float(self._rng.rand(1)[0]) < cfg.cn_prob)
            if gate and gated is not None:
                self.state, metrics = getattr(self.steps, gated)(
                    self.state, im, lb, generator=self._draws)
            else:
                self.state, metrics = self.steps.plain(self.state, im, lb)
            pending.append((metrics["loss"], int(lb.shape[-1])))
            if i % cfg.print_freq == 0:
                _resolve(pending, losses)
                print(f"Train Loss {losses.avg:.3f}")
        _resolve(pending, losses)
        return losses.avg

    # ---- full run --------------------------------------------------------

    def evaluate_clean(self):
        return evaluate(self.steps.eval_sum, self.state, self.test_loader,
                        prefetch_depth=self.cfg.prefetch_depth)

    def fit(self, epochs: Optional[int] = None) -> float:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        with open(self.log_file, "a") as f:
            f.write(f"dataset: {cfg.dataset}\n")
            f.write(f"batch size: {cfg.batch_size}\n")
            f.write(f"lr: {cfg.lr}\n")
            f.write(f"momentum: {cfg.momentum}\n")
            f.write(f"weight_decay: {cfg.weight_decay}\n")
            f.write("epoch\tlr\tTrain Loss\tTest Err1\tBest Test Err1\n")

        try:
            for epoch in range(self.start_epoch, epochs):
                lr = float(self.schedule(self.state.step))
                t0 = time.time()
                train_loss = self.train_epoch()
                test_loss, test_acc = self.evaluate_clean()
                is_best = test_acc > self.best_acc
                self.best_acc = max(test_acc, self.best_acc)
                save_checkpoint(self.state, type(self.state.model).__name__,
                                self.exp_dir, epoch + 1, self.best_acc,
                                is_best)
                with open(self.log_file, "a") as f:
                    f.write(f"{epoch:d}\t{lr:g}\t{train_loss:2.2f}\t"
                            f"{100 - 100. * test_acc:2.2f}\t"
                            f"{100 - 100. * self.best_acc:2.2f}\n")
                print(f"epoch {epoch}: loss {train_loss:.3f} "
                      f"err {100 - 100. * test_acc:.2f} "
                      f"({time.time() - t0:.1f}s)")
        finally:
            self.close()
        return self.best_acc

    def close(self):
        """Tear down the loaders (idempotent)."""
        for ld in (self.train_loader, self.test_loader):
            ld.close()

    def test_corruptions(self) -> float:
        cfg = self.cfg
        mean_acc, _ = evaluate_cifar_c(
            self.steps.eval_sum, self.state, cfg.corrupt_data_dir,
            cfg.num_classes, cfg.eval_batch_size,
            prefetch_depth=cfg.prefetch_depth)
        print(f"Mean Corruption Error: {100 - 100. * mean_acc:.3f}")
        return mean_acc


def _resolve(pending, meter: AverageMeter) -> None:
    """Bring the pending (loss, batch) pairs to the host with one wait and
    add them to ``meter`` in order."""
    if pending:
        values = torch.stack([v for v, _ in pending]).tolist()
        for v, (_, m) in zip(values, pending):
            meter.update(v, m)
        pending.clear()
