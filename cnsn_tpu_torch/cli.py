"""Command-line entry points of the port: port of ``cnsn_tpu/cli.py``'s
``train``, ``eval`` and ``export``.

Usage:
  python -m cnsn_tpu_torch.cli train --config cnsn_tpu/configs/cifar10/wideresnet/cnsn.yaml [key=value ...]
  python -m cnsn_tpu_torch.cli eval  --config ... resume=<ckpt> [key=value ...]
  python -m cnsn_tpu_torch.cli export --config ... --out model.pt2 \
      [resume=<ckpt>] [--seed 0] [key=value ...]
  python -m cnsn_tpu_torch.cli seg-train --config cnsn_tpu/configs/segmentation/gtav_fcn50_cnsn.yaml \
      [synthetic_data=true | data_root=... train_list=... val_list=... cross_val_list=...] [key=value ...]
  python -m cnsn_tpu_torch.cli seg-eval --config ... resume=<seg_ckpt> [key=value ...]
  python -m cnsn_tpu_torch.cli seg-export --config ... --out seg.pt2 \
      [resume=<seg_ckpt> | weight=<seg_ckpt>] [--seed 0] [arch=psp ...]

Everything runs on the card unless ``--device cpu`` asks for the CPU.
``train`` and ``seg-train`` with ``num_devices=N`` (N > 1) start N ranks
(``parallel/launch.py::spawn``, the reference's ``mp.spawn``): each
rank on ``cuda:(rank % cards)`` over NCCL where every rank has a card,
over gloo where they share one (or ``--device cpu``); under ``torchrun
--nproc-per-node N`` each process joins the launch's group instead.  A
rank that raises stops the others and the launch exits non-zero; only
rank 0 prints and writes.  ``eval`` and ``seg-eval`` run in one process
whatever ``num_devices`` says, and read a checkpoint of any width.
``remat=true`` rematerialises the ResNets' bottlenecks (``seg-train``: or
a stage spec, ``remat=1_2``); ``ckpt_backend=orbax`` keeps step
checkpoints with a SIGTERM flush, ``resume=`` then naming the experiment
directory (``train``) or restoring from ``save_path`` by itself
(``seg-train``).
``export`` and ``seg-export`` take the weights of a checkpoint
(``resume=``, or ``weight=`` for ``seg-export``), or random ones drawn
from ``--seed``.  The pipelined export (``--pipeline-stages``) is not
ported.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .config import apply_overrides, load_config

__all__ = ["main"]


def _install_tee(exp_dir):
    """tee stdout/stderr into the exp dir (train_cnsn.sh:
    ``2>&1 | tee ${model_dir}/train-$now.log``); returns the function
    that puts the streams back."""
    from .utils.provenance import TeeLog
    path = os.path.join(exp_dir, f"train-{time.strftime('%Y%m%d_%H%M%S')}.log")
    saved = sys.stdout, sys.stderr
    sys.stdout = TeeLog(sys.stdout, path)
    sys.stderr = TeeLog(sys.stderr, path)

    def restore():
        sys.stdout.flush()
        sys.stderr.flush()
        tees = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = saved
        for tee in tees:
            tee.close()

    return restore


def _export_main(cfg, args):
    """Export the eval forward as a ``torch.export`` artifact
    (``serving.py``), with a checkpoint's weights (``resume=``) or random
    ones from ``--seed``."""
    from .models import build_classifier
    from .serving import export_classifier, save_artifact
    from .train.trainer import DTYPES

    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                         f"{sorted(DTYPES)}")
    # remat reaches the ResNets only, as in JAX (cnsn_tpu/cli.py:142-143);
    # the exported eval forward runs every block as it is
    knobs = {"remat": cfg.remat} if cfg.model.startswith("resnet") else {}
    model = build_classifier(cfg.model, cfg.num_classes, device=args.device,
                             seed=args.seed, pos=cfg.pos, crop=cfg.crop,
                             beta=cfg.beta, cnsn_type=cfg.cnsn_type,
                             dtype=DTYPES[cfg.compute_dtype], **knobs)
    if cfg.resume:
        from .utils.checkpoint import load_checkpoint
        model.load_state_dict(load_checkpoint(cfg.resume)["state_dict"],
                              strict=True)
    image_size = cfg.resolved_image_size
    save_artifact(export_classifier(model, image_size), args.out)
    print(f"exported {args.out} ({os.path.getsize(args.out)} bytes, "
          f"device={args.device}, in_shape=(batch, {image_size}, "
          f"{image_size}, 3))")


def _seg_data(args) -> dict:
    """The segmentation YAML, then the ``key=value`` overrides."""
    import yaml

    data = {}
    if args.config:
        with open(args.config) as f:
            data = yaml.safe_load(f) or {}
    for pair in args.overrides:
        k, _, raw = pair.partition("=")
        data[k] = yaml.safe_load(raw)
    return data


def _seg_export_main(args):
    """Export a segmenter's eval forward (JAX ``cli.py:98-130``): the
    config's keys that ``SegConfig`` has (data keys are dropped), the
    weights of ``weight=`` or ``resume=`` (else random ones from
    ``--seed``), exported at (train_h, train_w) on ``--device``."""
    import torch

    from .segmentation.trainer import (SegConfig, build_seg_model,
                                       config_fields)
    from .serving import export_segmenter, save_artifact
    from .utils.device import resolve_device

    fields = config_fields()
    cfg = SegConfig(**{k: v for k, v in _seg_data(args).items()
                       if k in fields})
    model = build_seg_model(
        cfg, generator=torch.Generator().manual_seed(args.seed))
    path = cfg.weight or cfg.resume
    if path:
        from .utils.checkpoint import load_checkpoint
        model.load_state_dict(load_checkpoint(path)["state_dict"],
                              strict=True)
    model = model.to(resolve_device(args.device))
    hw = (cfg.train_h, cfg.train_w)
    save_artifact(export_segmenter(model, hw), args.out)
    print(f"exported {args.out} ({os.path.getsize(args.out)} bytes, "
          f"arch={cfg.arch}, device={args.device}, in_shape=(batch, "
          f"{hw[0]}, {hw[1]}, 3))")


def _seg_main(args):
    """Segmentation training and validation (reference tool/
    train_cnsn.sh flow): the YAML, then the ``key=value`` overrides; the
    data from ``synthetic_data`` or the list files under ``data_root``;
    unknown keys raise."""
    from .segmentation.data import make_list_dataset, synthetic_seg_dataset
    from .segmentation.trainer import SegConfig, SegTrainer, config_fields

    data = _seg_data(args)
    data_root = data.pop("data_root", None)
    train_list = data.pop("train_list", None)
    val_list = data.pop("val_list", None)
    cross_list = data.pop("cross_val_list", None)
    synthetic = data.pop("synthetic_data", False)
    unknown = set(data) - config_fields()
    if unknown:
        raise ValueError(f"unknown seg config keys: {sorted(unknown)}")
    if args.command == "seg-eval":
        data["num_devices"] = None  # one process, a checkpoint of any width
    cfg = SegConfig(**data)
    if synthetic:
        train_ds = synthetic_seg_dataset(32, hw=(cfg.train_h + 16,
                                                 cfg.train_w + 16),
                                         classes=cfg.classes)
        val_ds = synthetic_seg_dataset(8, hw=(cfg.train_h, cfg.train_w),
                                       classes=cfg.classes, seed=7)
        cross_ds = None
    else:
        train_ds = make_list_dataset(data_root, train_list)
        val_ds = make_list_dataset(data_root, val_list) if val_list else None
        cross_ds = (make_list_dataset(data_root, cross_list)
                    if cross_list else None)
    trainer = SegTrainer(cfg, train_ds, val_ds, cross_ds, device=args.device)
    restore = (_install_tee(cfg.save_path)
               if cfg.snapshot and trainer.dp.is_writer else None)
    try:
        if args.command == "seg-train":
            trainer.fit()
        else:
            trainer.validate()
    finally:
        trainer.close()
        if restore is not None:
            restore()


def _rank_main(argv):
    """One rank of a ``num_devices`` launch: ``main`` again, inside the
    group (only rank 0's standard output is kept)."""
    from .parallel import distributed
    if distributed.world().rank != 0:
        sys.stdout = open(os.devnull, "w")
    main(argv)


def _ranks(args, num_devices) -> bool:
    """Run ``args`` on the ranks it asks for: True where this call did
    (a launch of N > 1 ranks, or a torchrun process, from a process of no
    group); False where the caller runs it here."""
    from .parallel import distributed, launch
    if distributed.world() is not None:
        return False
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:  # torchrun
        distributed.initialize(device=args.device)
        try:
            _rank_main(args.argv)
        finally:
            distributed.shutdown()
        return True
    if (num_devices or 1) <= 1:
        return False
    launch.spawn(_rank_main, int(num_devices), args=(args.argv,),
                 device=args.device)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cnsn_tpu_torch")
    parser.add_argument("command", choices=["train", "eval", "export",
                                            "seg-train", "seg-eval",
                                            "seg-export"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="model.pt2",
                        help="output path for export and seg-export")
    parser.add_argument("--device", default="cuda",
                        help="device to run on (export: the artifact's)")
    parser.add_argument("--seed", type=int, default=0,
                        help="export, seg-export: seed of the random "
                             "weights when no checkpoint is given")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides")
    # positional overrides may follow options (older argparse cannot mix
    # them in one parse_args)
    args = parser.parse_intermixed_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)

    if args.command == "seg-export":
        return _seg_export_main(args)
    if args.command == "seg-train" and _ranks(
            args, _seg_data(args).get("num_devices")):
        return None
    if args.command.startswith("seg-"):
        return _seg_main(args)
    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if args.command == "export":
        return _export_main(cfg, args)
    if args.command == "train" and _ranks(args, cfg.num_devices):
        return None
    if args.command == "eval":
        cfg.num_devices = None  # one process reads a checkpoint of any width

    from .train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    restore = (_install_tee(trainer.exp_dir)
               if cfg.snapshot and trainer.dp.is_writer else None)
    try:
        if args.command == "train":
            trainer.fit()
        else:
            loss, acc = trainer.evaluate_clean()
            print(f"Clean\n\tTest Loss {loss:.3f} | "
                  f"Test Error {100 - 100. * acc:.2f}")
        if cfg.corrupt_data_dir:
            trainer.test_corruptions()
    finally:
        trainer.close()
        if restore is not None:
            restore()


if __name__ == "__main__":
    main()
