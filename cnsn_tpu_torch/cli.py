"""Command-line entry point of the port: the ``export`` subcommand of
``cnsn_tpu/cli.py``.

Usage:
  python -m cnsn_tpu_torch.cli export \
      --config cnsn_tpu/configs/imagenet/resnet50/sn.yaml --out model.pt2 \
      [--device cuda] [--seed 0] [key=value ...]

The weights are random, drawn from ``--seed``; loading a checkpoint
belongs to the training slice.  The other JAX subcommands are not ported.
"""
from __future__ import annotations

import argparse
import os

import torch

from .config import apply_overrides, load_config
from .models import build_classifier
from .serving import export_classifier, save_artifact

_DTYPES = {"fp32": None, "bf16": torch.bfloat16}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cnsn_tpu_torch")
    parser.add_argument("command", choices=["export"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="model.pt2")
    parser.add_argument("--device", default="cuda",
                        help="device the artifact is exported on and for")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                         f"{sorted(_DTYPES)}")
    model = build_classifier(cfg.model, cfg.num_classes, device=args.device,
                             seed=args.seed, pos=cfg.pos, crop=cfg.crop,
                             beta=cfg.beta, cnsn_type=cfg.cnsn_type,
                             dtype=_DTYPES[cfg.compute_dtype])
    image_size = cfg.resolved_image_size
    save_artifact(export_classifier(model, image_size), args.out)
    print(f"exported {args.out} ({os.path.getsize(args.out)} bytes, "
          f"device={args.device}, in_shape=(batch, {image_size}, "
          f"{image_size}, 3))")


if __name__ == "__main__":
    main()
