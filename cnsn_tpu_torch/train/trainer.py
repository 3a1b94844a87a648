"""Host-side training loop: port of ``cnsn_tpu/train/trainer.py`` for
CIFAR and ImageNet (reference mains: cifar.py:315-511,
imagenet.py:453-650).

A per-epoch loop over the host loader (CIFAR arrays, or an ImageNet image
folder; host AugMix for the AugMix regimes, or with ``ondevice_augmix``
the uint8 geometry batch, whose views ``data/augmix_device.py`` builds on
the card), its batches staged onto the card ahead of the step
(``utils/prefetch.py``); the stochastic CN gate
(``RandomState(seed).rand() < cn_prob``, cifar.py:127-128) picks the step
function per batch; the evaluation (CIFAR-C, or ImageNet-C and its mCE),
``log.txt`` and checkpoints mirror the JAX package's layout.  It runs on
the card unless the caller asks for the CPU.  The loaders' worker pools
live until ``close()``, so a second ``fit()`` keeps them.  What the port
does not have yet raises when the Trainer is built (``NOT_PORTED``).

``num_devices`` = N > 1 trains on N ranks, one process each, in a group
that ``parallel/`` set up (``cli train num_devices=N`` spawns them, or
``torchrun``); each rank runs the step JAX's ``DataParallel`` runs over N
devices, on its rows of each global batch: its loaders yield those rows
bit for bit (``shard``), BatchNorm's statistics are the global batch's,
CrossNorm pairs within the rank's rows (``num_groups`` = N), the
gradients are averaged; the loss meter reads the global means every
``print_freq`` steps; the evaluation pads the last batch to a multiple
of N with label −1 and all-reduces its sums; rank 0 names and makes the
experiment directory and alone writes log.txt and the checkpoints (which
load into one process); under ``ckpt_backend: orbax`` a SIGTERM to any
rank is flushed by every rank at the same step.

``remat`` reaches only the ResNet models, as in JAX (``cnsn_tpu/train/
trainer.py:58-59``): on the CIFAR models it is ignored, not refused.
``ckpt_backend: orbax`` (JAX ``trainer.py:153-185,323-343``) keeps step
checkpoints under ``<exp>/orbax/`` (``utils/orbax_io.py``; the port's own
format, which the JAX package does not read): ``resume=`` is the
experiment directory, whose newest step is restored with its epoch and
best accuracy; each epoch ends with an asynchronous save; a SIGTERM is
flushed at the next step boundary and the process exits with 143.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.augmix_device import apply_augmix, draw_augmix
from ..data.cifar import CifarLoader, load_cifar
from ..data.imagenet import ImageNetLoader, imagenet_c_dir, scan_image_folder
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..evaluation.classify import (CORRUPTIONS, compute_mce, evaluate,
                                   evaluate_cifar_c)
from ..models import build_model
from ..parallel import distributed
from ..parallel.mesh import DataParallel, make_mesh
from ..utils.checkpoint import restore_state, save_checkpoint
from ..utils.device import resolve_device
from ..utils.meters import AverageMeter, get_log_dir_path
from ..utils.prefetch import batch_put, device_prefetch
from .schedules import cosine_lr, imagenet_step_lr
from .steps import StepFns, create_train_state

__all__ = ["Trainer", "NOT_PORTED"]

DTYPES = {"fp32": None, "bf16": torch.bfloat16}

# (what is set, the ROADMAP item that ports it), checked in this order
NOT_PORTED = (
    (lambda c: c.fsdp, "fsdp", "ROADMAP queue 1, item 4b: parallel/fsdp.py"),
)
CKPT_BACKENDS = ("msgpack", "orbax")

# regime → (the StepFns method the gate picks, the one it picks
# otherwise) (cnsn_tpu/train/trainer.py:259-283); None: no gated step
_GATED = {"plain": (None, "plain"), "cn": ("cn", "plain"),
          "cn_consistency": ("cn_consistency", "plain"),
          "cn_augmix": ("augmix_cn", "augmix"),
          "cn_image": ("cn_image", "plain"),
          "cn_image_consist": ("cn_image_consist", "plain"),
          "cn_image_augmix": ("cn_image_augmix", "augmix")}
# no_jsd: the one AugMix view and plain cross-entropy (+ the CN gate)
_NO_JSD = ("cn", "plain")


def _check_ported(cfg: ExperimentConfig) -> None:
    for is_set, what, item in NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{what} (regime {cfg.regime!r}) is not yet ported to "
                f"cnsn_tpu_torch ({item})")
    if cfg.regime not in _GATED:
        raise ValueError(cfg.regime)
    if cfg.ckpt_backend not in CKPT_BACKENDS:
        raise ValueError(f"ckpt_backend {cfg.ckpt_backend!r}: one of "
                         f"{CKPT_BACKENDS}")
    if cfg.dataset not in ("cifar10", "cifar100", "imagenet"):
        raise ValueError(f"unknown dataset: {cfg.dataset}")
    if cfg.dataset == "imagenet" and cfg.no_jsd:
        raise ValueError("no_jsd is a CIFAR AugMix knob "
                         "(reference utils.py:100-113)")
    if "augmix" in cfg.regime and cfg.no_jsd and cfg.ondevice_augmix:
        raise ValueError(
            "no_jsd uses the host single-view AugMix path "
            "(data/cifar.py train_augmix_nojsd); it does not "
            "compose with ondevice_augmix")
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
        _check_ported(cfg)
        # the ranks of a process group (cli train num_devices=N, torchrun):
        # this rank's device, its rows of each batch
        self.dp = DataParallel(make_mesh(cfg.num_devices))
        w = distributed.world()
        self.device = w.device if w is not None else resolve_device(device)
        width = self.dp.num_shards
        if cfg.batch_size % width != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by the "
                f"data-parallel width {width} (set num_devices to control "
                "it)")
        shard = (self.dp.rank, width) if w is not None else None
        np.random.seed(cfg.seed)

        model_kw = dict(pos=cfg.pos, crop=cfg.crop, beta=cfg.beta,
                        cnsn_type=cfg.cnsn_type,
                        dtype=DTYPES[cfg.compute_dtype])
        if cfg.model.startswith("resnet"):
            model_kw["remat"] = cfg.remat
        self.model = build_model(
            cfg.model, cfg.num_classes,
            generator=torch.Generator().manual_seed(cfg.seed),
            num_groups=width, **model_kw)

        self.image_size = cfg.resolved_image_size
        augmix = "augmix" in cfg.regime
        # on-device AugMix: the loaders hand over the uint8 geometry batch
        self.ondevice = augmix and cfg.ondevice_augmix
        aug_kw = dict(aug_severity=cfg.aug_severity,
                      mixture_width=cfg.mixture_width,
                      mixture_depth=cfg.mixture_depth, all_ops=cfg.all_ops)
        if cfg.dataset == "imagenet":
            mode = "train"
            if augmix:
                mode = "train_geom" if self.ondevice else "train_augmix"
            self.train_loader = ImageNetLoader(
                scan_image_folder(os.path.join(cfg.data_dir, "train")),
                cfg.batch_size, mode=mode, seed=cfg.seed, workers=cfg.workers,
                image_size=self.image_size, mp_workers=cfg.augmix_workers,
                shard=shard, **aug_kw)
            self.test_loader = ImageNetLoader(
                scan_image_folder(os.path.join(cfg.data_dir, "validation")),
                cfg.eval_batch_size, mode="eval", workers=cfg.workers,
                image_size=self.image_size, shard=shard)
        else:
            mode = "train"
            if self.ondevice:
                mode = "train_geom"
            elif augmix:
                mode = "train_augmix_nojsd" if cfg.no_jsd else "train_augmix"
            self.train_data = load_cifar(cfg.data_dir, cfg.dataset, True,
                                         synthetic=cfg.synthetic_data)
            self.test_data = load_cifar(cfg.data_dir, cfg.dataset, False,
                                        synthetic=cfg.synthetic_data)
            self.train_loader = CifarLoader(
                self.train_data, cfg.batch_size, mode=mode, seed=cfg.seed,
                workers=cfg.augmix_workers, shard=shard, **aug_kw)
            self.test_loader = CifarLoader(self.test_data,
                                           cfg.eval_batch_size, mode="eval",
                                           shard=shard)

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
        self.dp.replicate(self.state.model)
        if cfg.pretrained and os.path.isfile(cfg.pretrained):
            unmatched = self._load_pretrained(cfg.pretrained)
            print(f"loaded pretrained '{cfg.pretrained}' "
                  f"({unmatched} unmatched keys)")
        self.steps = StepFns(active_num=cfg.active_num or 1,
                             consist_wt=cfg.consist_wt or 0.0,
                             image_crop=cfg.crop or "neither",
                             image_beta=cfg.beta or 1.0, num_groups=width)
        self._gated, self._ungated = (
            _NO_JSD if cfg.regime == "cn_augmix" and cfg.no_jsd
            else _GATED[cfg.regime])

        self.start_epoch = 0
        self.best_acc = 0.0
        self.ckpt = self._preempt = self._staged = None
        if cfg.ckpt_backend == "orbax":
            self._init_orbax()
        elif cfg.resume and os.path.isfile(cfg.resume):
            self.state, self.start_epoch, self.best_acc = restore_state(
                cfg.resume, self.state)
            self.exp_dir = os.path.dirname(cfg.resume)
            print(f"=> loaded checkpoint '{cfg.resume}' "
                  f"(epoch {self.start_epoch})")
        else:
            self.exp_dir = self._new_exp_dir()
        self.log_file = os.path.join(self.exp_dir, "log.txt")
        if cfg.snapshot and self.dp.is_writer:
            # provenance snapshot (train_cnsn.sh: cp script+config into
            # the exp dir); the CLI adds the log tee
            from ..utils.provenance import snapshot_experiment
            snapshot_experiment(self.exp_dir, cfg, tee=False)
        self._rng = np.random.RandomState(cfg.seed)
        # CrossNorm's draws (site masks, pairings, boxes) on the host; the
        # JAX package folds the step index into key(seed + 7919): the same
        # distributions, other numbers
        self._draws = torch.Generator().manual_seed(cfg.seed + 7919)
        # on-device AugMix's draws on the host (JAX splits them off each
        # step's key); the statistics follow the dataset (CIFAR 0.5/0.5,
        # cifar.py:330; ImageNet's, imagenet.py:473-475).  The chain has
        # the nine default ops: all_ops does not reach it, as in JAX.
        self._augmix_gen = torch.Generator().manual_seed(cfg.seed + 104729)
        self._augmix_norm = (
            dict(mean=tuple(map(float, IMAGENET_MEAN)),
                 std=tuple(map(float, IMAGENET_STD)))
            if cfg.dataset == "imagenet" else {})
        # seconds the step loop waited for each staged batch, last epoch
        self.data_wait = AverageMeter()

    def _init_orbax(self) -> None:
        """The experiment directory (``resume=`` when it is one), its
        newest step restored, then the SIGTERM handler: installed only
        once ``_epoch`` exists, which the handler reads."""
        from ..utils.orbax_io import OrbaxCheckpointer, install_preemption_save
        cfg = self.cfg
        if cfg.resume and os.path.isdir(cfg.resume):
            self.exp_dir = cfg.resume
        else:
            self.exp_dir = self._new_exp_dir()
        self.ckpt = OrbaxCheckpointer(
            os.path.join(os.path.abspath(self.exp_dir), "orbax"), keep=2)
        self.state, step, extra = self.ckpt.restore(
            self.state, extra_template={"epoch": 0, "best_acc": 0.0})
        if step is not None:
            self.start_epoch = int(extra["epoch"])
            self.best_acc = float(extra["best_acc"])
            print(f"=> restored orbax step {step} "
                  f"(epoch {self.start_epoch})")
        self._epoch = self.start_epoch
        self._preempt = install_preemption_save(
            lambda: (self.state.step, self.state), self.ckpt,
            get_extra=lambda: {"epoch": self._epoch,
                               "best_acc": self.best_acc},
            exit_code=143, before_exit=self.close,
            writer=self.dp.is_writer)

    def _new_exp_dir(self) -> str:
        """A new experiment directory, named by rank 0 (the name reads the
        clock) and made there; every rank gets its path."""
        cfg = self.cfg
        path = None
        if self.dp.is_writer:
            path = get_log_dir_path(cfg.exp_dir, cfg.exp_id)
            os.makedirs(path, exist_ok=True)
        return distributed.broadcast_object(path)

    def _step_guard(self):
        """The block of one step: a SIGTERM inside it is flushed after
        (across ranks, at the first step's end where any rank had one)."""
        return (self._preempt.step() if self._preempt is not None
                else contextlib.nullcontext())

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

    def augmix_draws(self, n: int) -> dict:
        """``draw_augmix``'s draws for a batch of ``n`` images, from the
        Trainer's own generator."""
        cfg = self.cfg
        return draw_augmix(self._augmix_gen, n, float(cfg.aug_severity),
                           cfg.mixture_width, cfg.mixture_depth)

    def augmix_views(self, images_u8: torch.Tensor) -> torch.Tensor:
        """The (3, B, H, W, 3) views of a staged uint8 batch, built on its
        device (``cnsn_tpu/train/trainer.py:234-257``); across ranks from
        the global batch's draws, of which the rank takes its rows."""
        n = len(images_u8)
        draws = self.augmix_draws(distributed.global_rows(n)[0])
        draws = {k: distributed.local_rows(v, n, axis=1)
                 for k, v in draws.items()}
        return apply_augmix(images_u8, draws, **self._augmix_norm)

    def train_epoch(self) -> float:
        cfg = self.cfg
        losses = AverageMeter()
        self.data_wait.reset()
        # per-step losses stay on the device; resolving each at once would
        # make the host wait for every step
        pending = []
        staged = self._staged = _timed(
            device_prefetch(self.train_loader, batch_put(self.device),
                            depth=cfg.prefetch_depth), self.data_wait)
        for i, (im, lb) in enumerate(staged):
            if self.ondevice:
                im = self.augmix_views(im)
            gate = (cfg.cn_prob is not None
                    and float(self._rng.rand(1)[0]) < cfg.cn_prob)
            with self._step_guard():
                if gate and self._gated is not None:
                    self.state, metrics = getattr(self.steps, self._gated)(
                        self.state, im, lb, generator=self._draws)
                else:
                    self.state, metrics = getattr(self.steps, self._ungated)(
                        self.state, im, lb)
            pending.append((metrics["loss"],
                            int(lb.shape[-1]) * self.dp.num_shards))
            if i % cfg.print_freq == 0:
                _resolve(pending, losses, self.dp)
                if self.dp.is_writer:
                    print(f"Train Loss {losses.avg:.3f}")
        _resolve(pending, losses, self.dp)
        return losses.avg

    # ---- full run --------------------------------------------------------

    def evaluate_clean(self):
        return evaluate(self.steps.eval_sum, self.state, self.test_loader,
                        prefetch_depth=self.cfg.prefetch_depth, dp=self.dp)

    def _save(self, epoch: int, test_acc: float, is_best: bool) -> None:
        if self.ckpt is not None:
            # the write overlaps the next epoch's steps
            self.ckpt.save(self.state.step, self.state,
                           extra={"epoch": epoch + 1,
                                  "best_acc": self.best_acc},
                           metrics={"test_acc": float(test_acc)})
        else:
            save_checkpoint(self.state, type(self.state.model).__name__,
                            self.exp_dir, epoch + 1, self.best_acc, is_best,
                            keep_epoch_file=(self.cfg.dataset == "imagenet"))

    def _log(self, text: str) -> None:
        """Append to log.txt (rank 0 only)."""
        if self.dp.is_writer:
            with open(self.log_file, "a") as f:
                f.write(text)

    def fit(self, epochs: Optional[int] = None) -> float:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        self._log(f"dataset: {cfg.dataset}\n"
                  f"batch size: {cfg.batch_size}\n"
                  f"lr: {cfg.lr}\n"
                  f"momentum: {cfg.momentum}\n"
                  f"weight_decay: {cfg.weight_decay}\n"
                  "epoch\tlr\tTrain Loss\tTest Err1\tBest Test Err1\n")

        for epoch in range(self.start_epoch, epochs):
            self._epoch = epoch
            lr = float(self.schedule(self.state.step))
            t0 = time.time()
            train_loss = self.train_epoch()
            test_loss, test_acc = self.evaluate_clean()
            is_best = test_acc > self.best_acc
            self.best_acc = max(test_acc, self.best_acc)
            if self.dp.is_writer:
                self._save(epoch, test_acc, is_best)
            self._log(f"{epoch:d}\t{lr:g}\t{train_loss:2.2f}\t"
                      f"{100 - 100. * test_acc:2.2f}\t"
                      f"{100 - 100. * self.best_acc:2.2f}\n")
            if self.dp.is_writer:
                print(f"epoch {epoch}: loss {train_loss:.3f} "
                      f"err {100 - 100. * test_acc:.2f} "
                      f"({time.time() - t0:.1f}s)")
            distributed.barrier()
        if self.ckpt is not None:
            self.ckpt.wait_until_finished()
        return self.best_acc

    def close(self):
        """Stop the epoch's staging thread and the loaders' worker pools,
        and finish a checkpoint write in flight (idempotent).  ``fit``
        leaves the pools running, so that a second ``fit`` keeps its
        AugMix workers; the CLI closes the Trainer when it is done, and a
        SIGTERM flush before the process exits."""
        if self._staged is not None:
            try:
                self._staged.close()
            except ValueError:  # the flush runs inside the staging loop
                pass
            self._staged = None
        for ld in (self.train_loader, self.test_loader):
            ld.close()
        if self.ckpt is not None:
            self.ckpt.wait_until_finished()

    def test_corruptions(self) -> float:
        cfg = self.cfg
        if cfg.dataset == "imagenet":
            return self._test_corruptions_imagenet()
        mean_acc, _ = evaluate_cifar_c(
            self.steps.eval_sum, self.state, cfg.corrupt_data_dir,
            cfg.num_classes, cfg.eval_batch_size,
            prefetch_depth=cfg.prefetch_depth, dp=self.dp,
            verbose=self.dp.is_writer)
        print(f"Mean Corruption Error: {100 - 100. * mean_acc:.3f}")
        return mean_acc

    def _test_corruptions_imagenet(self) -> float:
        """ImageNet-C: a folder per corruption and severity → the
        AlexNet-normalized mCE (imagenet.py:426-450, 125-140).  Its
        loaders take their default image size (224) whatever
        ``image_size`` says, as the JAX package's do."""
        cfg = self.cfg
        corruption_accs = {}
        for corruption in CORRUPTIONS:
            accs = []
            for severity in range(1, 6):
                loader = ImageNetLoader(
                    scan_image_folder(imagenet_c_dir(
                        cfg.corrupt_data_dir, corruption, severity)),
                    cfg.eval_batch_size, mode="eval", workers=cfg.workers,
                    shard=self.test_loader.shard)
                _, acc = evaluate(self.steps.eval_sum, self.state, loader,
                                  prefetch_depth=cfg.prefetch_depth,
                                  dp=self.dp)
                accs.append(acc)
            corruption_accs[corruption] = accs
            print(f"{corruption}: avg err "
                  f"{100 * (1 - float(np.mean(accs))):.2f}")
        mce, ce_dict = compute_mce(corruption_accs)
        print("individual CEs:")
        for c in CORRUPTIONS:
            print(f"{c}: {ce_dict[c]: .2f}")
        print(f"mCE: {mce:.2f}")
        return mce


def _resolve(pending, meter: AverageMeter, dp: DataParallel) -> None:
    """Bring the pending (loss, batch) pairs to the host with one wait
    (across ranks, one all-reduce: the global batches' means) and add
    them to ``meter`` in order."""
    if pending:
        values = dp.mean([v for v, _ in pending]).tolist()
        for v, (_, m) in zip(values, pending):
            meter.update(v, m)
        pending.clear()
