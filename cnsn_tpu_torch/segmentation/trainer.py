"""Host-side segmentation trainer: port of
``cnsn_tpu/segmentation/trainer.py`` (reference segmentation/tool/
train_cnsn.py:83-451), on one card or, with ``num_devices`` = N > 1, on
the N ranks of a process group (``parallel/``; ``cli seg-train
num_devices=N``): each rank's loader yields its rows of each batch, the
cross-entropy is the global batch's mean over its valid pixels, the
metrics and the validation's sums are all-reduced, rank 0 writes.

The loader's batches are staged onto the card ahead of the step
(``utils/prefetch.py``); the per-iteration poly LR with 10× head groups
lives in the step (``train_seg.py``); the ``mix_prob`` gate
``RandomState(seed + 17).rand(1)[0] < mix_prob`` picks the CrossNorm
(aug) step per batch when ``cnsn_type`` has CrossNorm; the metrics stay on
the card and are drained every ``print_freq`` steps; validation pads the
tail batch with all-``ignore_label`` rows to one shape and sums on the
card, with one wait per loader; checkpoints rotate keep-last-N
(``seg_ckpt_<epoch>``, :255-261); an optional cross-domain (Cityscapes)
validation runs each epoch (:271-278).  It runs on the card unless the
caller asks for the CPU.  What the port does not have yet raises when the
trainer is built (``NOT_PORTED``).

``remat`` (True or a stage spec, ``backbone.py``) rematerialises the
backbone's bottlenecks.  ``ckpt_backend: orbax`` (JAX ``trainer.py:
220-260,380-410``) keeps the newest ``keep_last`` step checkpoints under
``<save_path>/orbax/`` (``utils/orbax_io.py``, the port's own format):
after the init-only ``weight`` load the newest step is restored, whatever
``resume`` says; a SIGTERM is flushed at the next step boundary and the
process exits with 143.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..nn.cnsn import set_num_groups
from ..parallel import distributed
from ..parallel.mesh import DataParallel, make_mesh
from ..utils.checkpoint import load_checkpoint, restore_state
from ..utils.checkpoint import save_checkpoint as _save
from ..utils.device import resolve_device
from ..utils.meters import AverageMeter
from ..utils.metrics_io import MetricWriter
from ..utils.prefetch import batch_put, device_prefetch
from .data import (Compose, Crop, Normalize, RandRotate, RandScale,
                   RandomGaussianBlur, RandomHorizontalFlip, SegLoader)
from .fcn import fcn_baseline, fcn_cnsn
from .pspnet import PSALite, PSANet, PSPNet
from .train_seg import SegStepFns, create_seg_train_state

__all__ = ["SegConfig", "SegTrainer", "build_seg_model",
           "default_train_transform", "NOT_PORTED"]

ARCHS = ("fcn", "fcn_cnsn", "psp", "psa", "psa_lite")
# (what is set, the ROADMAP item that ports it), checked in this order
NOT_PORTED = (
    (lambda c: c.fsdp, "fsdp", "ROADMAP queue 1, item 4b: parallel/fsdp.py"),
    (lambda c: (c.spatial or 1) > 1, "spatial > 1",
     "ROADMAP queue 1, item 4c: parallel/tensor.py"),
)
CKPT_BACKENDS = ("msgpack", "orbax")
# compute_dtype as the JAX SegConfig names it (jnp.dtype); params stay fp32
DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


@dataclass
class SegConfig:
    """Mirrors segmentation/config/gtav/gtav_fcn50_cnsn.yaml (every field
    of the JAX ``SegConfig``)."""
    arch: str = "fcn_cnsn"          # fcn | fcn_cnsn | psp | psa | psa_lite
    classes: int = 19
    train_h: int = 97
    train_w: int = 97
    scale_min: float = 0.5
    scale_max: float = 2.0
    rotate_min: float = -10.0
    rotate_max: float = 10.0
    ignore_label: int = 255
    aux_weight: float = 0.4
    base_lr: float = 0.01
    epochs: int = 80
    batch_size: int = 16
    prefetch_depth: int = 2  # host→card staging depth (0 disables)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    power: float = 0.9
    # CNSN knobs (gtav yaml :35-43)
    pos: Optional[str] = "residual"
    cn_pos: Optional[str] = "post"
    block_idxs: str = "1_2_3_4"
    crop: str = "style"
    cnsn_type: Optional[str] = "cnsn"
    beta: float = 1.0
    active_num: int = 1
    mix_prob: float = 0.5
    # PSA knobs (reference psanet.py:101-110 defaults; arch psa)
    psa_type: int = 2
    compact: bool = False
    shrink_factor: int = 2
    mask_h: int = 0
    mask_w: int = 0
    normalization_factor: float = 1.0
    psa_softmax: bool = True
    # compute type: None (float32) or 'bfloat16'; parameters stay fp32
    compute_dtype: Optional[str] = None
    remat: Any = False
    # infra
    seed: int = 1
    print_freq: int = 10
    save_path: str = "./exp/seg"
    # 'msgpack': torch.save files, keep-last rotation; 'orbax': step
    # checkpoints, async saves, SIGTERM flush, auto-restore
    ckpt_backend: str = "msgpack"
    snapshot: bool = True
    tensorboard: bool = False
    keep_last: int = 2
    batch_size_val: Optional[int] = None  # default: batch_size
    eval_freq: int = 1
    save_freq: int = 1
    start_epoch: int = 0
    weight: Optional[str] = None          # init-only checkpoint (weights)
    resume: Optional[str] = None          # full restore (+ optimizer, epoch)
    num_devices: Optional[int] = None
    spatial: int = 1
    fsdp: bool = False
    mean: tuple = (0.485 * 255, 0.456 * 255, 0.406 * 255)
    std: tuple = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def _check_ported(cfg: SegConfig) -> None:
    for is_set, what, item in NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{what} is not yet ported to cnsn_tpu_torch ({item})")
    if cfg.arch not in ARCHS:
        raise ValueError(f"unknown arch {cfg.arch}")
    if cfg.ckpt_backend not in CKPT_BACKENDS:
        raise ValueError(f"ckpt_backend {cfg.ckpt_backend!r}: one of "
                         f"{CKPT_BACKENDS}")
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: None, "
                         f"'float32' or 'bfloat16'")


def build_seg_model(cfg: SegConfig,
                    generator: Optional[torch.Generator] = None,
                    num_groups: int = 1):
    """The model of ``cfg.arch`` (JAX ``trainer.py:109-130``), its
    initializers drawn from ``generator``: 'fcn', 'fcn_cnsn', 'psp',
    'psa' (with the PSA knobs) or 'psa_lite'; PSANet and PSALite are
    built for (train_h, train_w) images.  ``num_groups``: the CrossNorm
    sites pair within that many contiguous blocks of the global batch
    (the data-parallel width; ``nn/cnsn.py::set_num_groups``)."""
    _check_ported(cfg)
    return set_num_groups(_build_seg(cfg, generator), num_groups)


def _build_seg(cfg, generator):
    dtype = DTYPES[cfg.compute_dtype]
    if cfg.arch == "fcn":
        return fcn_baseline(classes=cfg.classes, dtype=dtype,
                            remat=cfg.remat, generator=generator)
    kw = dict(classes=cfg.classes, block_idxs=cfg.block_idxs, pos=cfg.pos,
              cn_pos=cfg.cn_pos, cnsn_type=cfg.cnsn_type, crop=cfg.crop,
              beta=cfg.beta, dtype=dtype, remat=cfg.remat,
              generator=generator)
    if cfg.arch == "fcn_cnsn":
        return fcn_cnsn(**kw)
    if cfg.arch == "psp":
        return PSPNet(**kw)
    image_hw = (cfg.train_h, cfg.train_w)
    if cfg.arch == "psa":
        return PSANet(image_hw=image_hw, psa_type=cfg.psa_type,
                      compact=cfg.compact, shrink_factor=cfg.shrink_factor,
                      mask_h=cfg.mask_h, mask_w=cfg.mask_w,
                      normalization_factor=cfg.normalization_factor,
                      psa_softmax=cfg.psa_softmax, **kw)
    return PSALite(image_hw=image_hw, **kw)


def default_train_transform(cfg: SegConfig) -> Compose:
    """gtav yaml pipeline (train_cnsn.py:206-220 equivalent)."""
    return Compose([
        RandScale((cfg.scale_min, cfg.scale_max)),
        RandRotate((cfg.rotate_min, cfg.rotate_max), padding=cfg.mean,
                   ignore_label=cfg.ignore_label),
        RandomGaussianBlur(),
        RandomHorizontalFlip(),
        Crop((cfg.train_h, cfg.train_w), "rand", padding=cfg.mean,
             ignore_label=cfg.ignore_label),
        Normalize(cfg.mean, cfg.std),
    ])


def _summarize(inter, union, target):
    iou = inter / np.maximum(union, 1e-10)
    acc = inter / np.maximum(target, 1e-10)
    return (float(np.mean(iou)), float(np.mean(acc)),
            float(inter.sum() / max(target.sum(), 1e-10)))


class SegTrainer:
    def __init__(self, cfg: SegConfig, train_dataset, val_dataset=None,
                 cross_domain_dataset=None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        _check_ported(cfg)
        # the ranks of a process group (cli seg-train num_devices=N)
        self.dp = DataParallel(make_mesh(cfg.num_devices))
        w = distributed.world()
        self.device = w.device if w is not None else resolve_device(device)
        width = self.dp.num_shards
        if cfg.batch_size % width != 0:
            raise ValueError(f"batch_size {cfg.batch_size} must be "
                             f"divisible by the data-parallel width {width}")
        shard = (self.dp.rank, width) if w is not None else None
        np.random.seed(cfg.seed)
        self.model = build_seg_model(
            cfg, generator=torch.Generator().manual_seed(cfg.seed),
            num_groups=width)

        self.train_loader = SegLoader(train_dataset, cfg.batch_size,
                                      default_train_transform(cfg),
                                      seed=cfg.seed, shard=shard)
        val_tf = Compose([Crop((cfg.train_h, cfg.train_w), "center",
                               padding=cfg.mean,
                               ignore_label=cfg.ignore_label),
                          Normalize(cfg.mean, cfg.std)])
        bval = cfg.batch_size_val or cfg.batch_size
        val_kw = dict(shuffle=False, drop_last=False, shard=shard,
                      pad_label=cfg.ignore_label)
        self.val_loader = (SegLoader(val_dataset, bval, val_tf, **val_kw)
                           if val_dataset else None)
        self.cross_loader = (SegLoader(cross_domain_dataset, bval, val_tf,
                                       **val_kw)
                             if cross_domain_dataset else None)

        max_iter = cfg.epochs * len(self.train_loader)
        self.state = create_seg_train_state(
            self.model, cfg.base_lr, max_iter, cfg.power, cfg.momentum,
            cfg.weight_decay, device=self.device)
        self.dp.replicate(self.state.model)
        self.steps = SegStepFns(self.model, num_classes=cfg.classes,
                                active_num=cfg.active_num,
                                aux_weight=cfg.aux_weight,
                                ignore_label=cfg.ignore_label)
        self._gate = np.random.RandomState(cfg.seed + 17)
        # CrossNorm's draws (site mask, pairings, boxes) on the host; the
        # JAX package folds the step index into key(seed + 23): the same
        # distributions, other numbers
        self._draws = torch.Generator().manual_seed(cfg.seed + 23)
        # the gates of the steps taken, in order (True: the aug step)
        self.gates = []
        # rank 0 writes the snapshot, the metrics and the checkpoints
        if self.dp.is_writer:
            os.makedirs(cfg.save_path, exist_ok=True)
        if cfg.snapshot and self.dp.is_writer:
            from ..utils.provenance import snapshot_experiment
            snapshot_experiment(cfg.save_path, cfg, tee=False)
        self.writer = MetricWriter(os.path.join(cfg.save_path, "metrics"),
                                   tensorboard=cfg.tensorboard,
                                   enabled=self.dp.is_writer)
        distributed.barrier()
        self._epoch = cfg.start_epoch
        self.ckpt = self._preempt = None
        if cfg.ckpt_backend == "orbax":
            from ..utils.orbax_io import (OrbaxCheckpointer,
                                          install_preemption_save)
            self.ckpt = OrbaxCheckpointer(
                os.path.join(os.path.abspath(cfg.save_path), "orbax"),
                keep=cfg.keep_last)
            self._preempt = install_preemption_save(
                lambda: (self.state.step, self.state), self.ckpt,
                get_extra=lambda: {"epoch": self._epoch}, exit_code=143,
                before_exit=self.close, writer=self.dp.is_writer)
        if cfg.weight and os.path.isfile(cfg.weight):
            # init-only load (reference --weight vs --resume,
            # train_cnsn.py:179-204): weights and statistics, no optimizer
            self.state.model.load_state_dict(
                load_checkpoint(cfg.weight)["state_dict"], strict=True)
            print(f"=> loaded weight '{cfg.weight}'")
        # the full restore after the weight load (the reference's
        # precedence); orbax restores its newest step whatever resume says,
        # so a restart after a SIGTERM flush goes on where the run stopped
        restored = 0
        if self.ckpt is not None:
            restored = self.resume()
        elif cfg.resume:
            if os.path.isfile(cfg.resume):
                restored = self.resume(cfg.resume)
            else:
                print(f"=> no checkpoint found at '{cfg.resume}'")
        if restored:
            cfg.start_epoch = restored
            self._epoch = restored

    def train_epoch(self, epoch: int):
        cfg = self.cfg
        meters = {k: AverageMeter() for k in ("main", "aux", "loss")}
        sums = [np.zeros(cfg.classes) for _ in range(3)]
        # CrossNorm exists only when cnsn_type contains 'cn'; cn_pos alone
        # relocates a CrossNorm that is not there
        has_cn = bool(cfg.cnsn_type and "cn" in cfg.cnsn_type)
        t0 = time.time()
        pending = []  # device metrics, brought to the host every print_freq

        def drain():
            if not pending:
                return
            keys = ("main_loss", "aux_loss", "loss")
            scalars = torch.stack([torch.stack([m[k] for k in keys])
                                   for m, _, _ in pending])
            hists = torch.stack([torch.stack([m["intersection"], m["union"],
                                              m["target"]])
                                 for m, _, _ in pending])
            if distributed.world() is not None:
                # the global batches': the ranks' loss shares averaged,
                # their histograms summed, in one all-reduce
                both = self.dp.sum(torch.cat(
                    [scalars.double().flatten() / self.dp.num_shards,
                     hists.double().flatten()]))
                scalars = both[:scalars.numel()].view(scalars.shape)
                hists = both[scalars.numel():].view(hists.shape)
            scalars = scalars.tolist()
            hists = hists.cpu().numpy()
            for (_, n, step), vals, h in zip(pending, scalars, hists):
                for name, v in zip(("main", "aux", "loss"), vals):
                    meters[name].update(v, n)
                for acc, part in zip(sums, h):
                    acc += part
                self.writer.scalar("loss_train_batch", vals[0], step)
            pending.clear()

        staged = device_prefetch(self.train_loader, batch_put(self.device),
                                 depth=cfg.prefetch_depth)
        for i, (im, lb) in enumerate(staged):
            aug = bool(has_cn and self._gate.rand(1)[0] < cfg.mix_prob)
            self.gates.append(aug)
            with (self._preempt.step() if self._preempt is not None
                  else contextlib.nullcontext()):
                if aug:
                    self.state, m = self.steps.aug(self.state, im, lb,
                                                   generator=self._draws)
                else:
                    self.state, m = self.steps.plain(self.state, im, lb)
            step = epoch * len(self.train_loader) + i + 1
            pending.append((m, int(im.shape[0]) * self.dp.num_shards, step))
            if (i + 1) % cfg.print_freq == 0:
                drain()
                miou, _, _ = _summarize(*sums)
                print(f"Epoch [{epoch + 1}/{cfg.epochs}][{i + 1}/"
                      f"{len(self.train_loader)}] MainLoss "
                      f"{meters['main'].val:.4f} AuxLoss "
                      f"{meters['aux'].val:.4f} Loss "
                      f"{meters['loss'].val:.4f} mIoU {miou:.4f} "
                      f"({time.time() - t0:.1f}s)")
        drain()
        miou, macc, aacc = _summarize(*sums)
        self.writer.scalar("mIoU_train", miou, epoch)
        return meters["main"].avg, miou, macc, aacc

    def validate(self, loader=None, tag: str = "val"):
        """One-wait validation (reference per-batch loop: train_cnsn.py:
        388-451).  A tail batch is padded to the full batch with rows of
        zeros labelled all ``ignore_label``, which add nothing to the loss
        or the histograms, so every batch has one shape.  The sums stay on
        the card (the histograms in float64) until the loader is done.
        The loss is the mean over the valid pixels.  Across ranks each
        evaluates its rows, a full batch being its share of the global
        one (the tail's share padded by the loader, then to that), and
        the sums are all-reduced once."""
        loader = loader or self.val_loader
        if loader is None:
            return None
        cfg = self.cfg
        full = -(-loader.batch_size // self.dp.num_shards)
        put = batch_put(self.device)

        def pad(batch):
            images, labels = batch
            if len(labels) < full:
                n = full - len(labels)
                images = np.concatenate(
                    [images, np.zeros((n,) + images.shape[1:], images.dtype)])
                labels = np.concatenate(
                    [labels, np.full((n,) + labels.shape[1:],
                                     cfg.ignore_label, labels.dtype)])
            return put((images, labels))

        totals = None
        for im, lb in device_prefetch(loader, pad, depth=cfg.prefetch_depth):
            out = self.steps.eval_sum(self.state, im, lb)
            out = {k: v.double() for k, v in out.items()}
            totals = out if totals is None else {
                k: totals[k] + out[k] for k in totals}
        if totals is None:
            return None
        if distributed.world() is not None:
            keys = sorted(totals)
            flat = self.dp.sum(torch.cat([totals[k].reshape(-1)
                                          for k in keys]))
            parts = flat.split([totals[k].numel() for k in keys])
            totals = {k: p.view(totals[k].shape)
                      for k, p in zip(keys, parts)}
        totals = {k: v.cpu().numpy() for k, v in totals.items()}
        inter, union, target = (totals["intersection"], totals["union"],
                                totals["target"])
        loss = float(totals["nll_sum"]) / max(float(totals["valid_px"]), 1.0)
        miou, macc, aacc = _summarize(inter, union, target)
        print(f"{tag} result: mIoU/mAcc/allAcc "
              f"{miou:.4f}/{macc:.4f}/{aacc:.4f}")
        return {"loss": loss, "mIoU": miou, "mAcc": macc, "allAcc": aacc,
                "iou_class": inter / np.maximum(union, 1e-10)}

    def resume(self, path: Optional[str] = None) -> int:
        """Restore weights, statistics, momentum buffers and the update
        count; returns the epoch (train_cnsn.py:191-204 --resume).  Under
        orbax ``path`` is ignored: the newest step of ``<save_path>/
        orbax`` (0 where there is none)."""
        if self.ckpt is not None:
            self.state, step, extra = self.ckpt.restore(
                self.state, extra_template={"epoch": 0})
            if step is None:
                return 0
            epoch = int(extra["epoch"])
            print(f"=> restored orbax step {step} (epoch {epoch})")
            return epoch
        if path is None:
            raise ValueError("the msgpack backend resumes from a "
                             "checkpoint path")
        self.state, epoch, _ = restore_state(path, self.state)
        print(f"=> loaded checkpoint '{path}' (epoch {epoch})")
        return epoch

    def save_checkpoint(self, epoch: int) -> str:
        """``seg_last_ckpt`` and ``seg_ckpt_<epoch>``, the newest
        ``keep_last`` epoch files kept (train_cnsn.py:255-261); under
        orbax an asynchronous save of the step, the newest ``keep_last``
        steps kept."""
        cfg = self.cfg
        if not self.dp.is_writer:
            return os.path.join(cfg.save_path, f"seg_ckpt_{epoch}")
        if self.ckpt is not None:
            self.ckpt.save(self.state.step, self.state,
                           extra={"epoch": epoch})
            return os.path.join(self.ckpt.directory, str(self.state.step))
        path = _save(self.state, "seg", cfg.save_path, epoch, 0.0, False,
                     keep_epoch_file=True)
        epochs = sorted(
            int(f.rsplit("_", 1)[1]) for f in os.listdir(cfg.save_path)
            if f.startswith("seg_ckpt_"))
        for old in epochs[:-cfg.keep_last]:
            os.remove(os.path.join(cfg.save_path, f"seg_ckpt_{old}"))
        return path

    def fit(self, epochs: Optional[int] = None):
        cfg = self.cfg
        end = epochs if epochs is not None else cfg.epochs
        for epoch in range(cfg.start_epoch, end):
            self._epoch = epoch
            _, miou, macc, aacc = self.train_epoch(epoch)
            print(f"Train epoch [{epoch + 1}]: mIoU/mAcc/allAcc "
                  f"{miou:.4f}/{macc:.4f}/{aacc:.4f}")
            if (epoch + 1) % cfg.save_freq == 0 or epoch + 1 == end:
                self.save_checkpoint(epoch + 1)
                distributed.barrier()
            if (epoch + 1) % cfg.eval_freq == 0:
                if self.val_loader:
                    self.validate()
                if self.cross_loader:
                    self.validate(self.cross_loader, tag="cross-domain")
        if self.ckpt is not None:
            self.ckpt.wait_until_finished()
        return self.state

    def close(self):
        """Close the metric writer and finish a checkpoint write in
        flight."""
        self.writer.close()
        if self.ckpt is not None:
            self.ckpt.wait_until_finished()


def config_fields():
    return {f.name for f in dataclasses.fields(SegConfig)}
