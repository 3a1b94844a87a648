"""Command-line entry points of the port: port of ``cnsn_tpu/cli.py``'s
``train``, ``eval`` and ``export``.

Usage:
  python -m cnsn_tpu_torch.cli train --config cnsn_tpu/configs/cifar10/wideresnet/cnsn.yaml [key=value ...]
  python -m cnsn_tpu_torch.cli eval  --config ... resume=<ckpt> [key=value ...]
  python -m cnsn_tpu_torch.cli export --config ... --out model.pt2 \
      [resume=<ckpt>] [--seed 0] [key=value ...]

Everything runs on the card unless ``--device cpu`` asks for the CPU.
``export`` takes the weights of a checkpoint (``resume=``), or random ones
drawn from ``--seed``.  The segmentation subcommands and the pipelined
export (``--pipeline-stages``) are not ported.
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
    model = build_classifier(cfg.model, cfg.num_classes, device=args.device,
                             seed=args.seed, pos=cfg.pos, crop=cfg.crop,
                             beta=cfg.beta, cnsn_type=cfg.cnsn_type,
                             dtype=DTYPES[cfg.compute_dtype])
    if cfg.resume:
        from .utils.checkpoint import load_checkpoint
        model.load_state_dict(load_checkpoint(cfg.resume)["state_dict"],
                              strict=True)
    image_size = cfg.resolved_image_size
    save_artifact(export_classifier(model, image_size), args.out)
    print(f"exported {args.out} ({os.path.getsize(args.out)} bytes, "
          f"device={args.device}, in_shape=(batch, {image_size}, "
          f"{image_size}, 3))")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cnsn_tpu_torch")
    parser.add_argument("command", choices=["train", "eval", "export"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="model.pt2",
                        help="output path for export")
    parser.add_argument("--device", default="cuda",
                        help="device to run on (export: the artifact's)")
    parser.add_argument("--seed", type=int, default=0,
                        help="export: seed of the random weights when no "
                             "checkpoint is given")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides")
    # positional overrides may follow options (older argparse cannot mix
    # them in one parse_args)
    args = parser.parse_intermixed_args(argv)

    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if args.command == "export":
        return _export_main(cfg, args)

    from .train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    restore = _install_tee(trainer.exp_dir) if cfg.snapshot else None
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
