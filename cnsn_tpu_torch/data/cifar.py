"""CIFAR-10/100 datasets, CIFAR-C corruption arrays, and a host loader:
port of ``cnsn_tpu/data/cifar.py``, numpy only.

Reads the standard python-pickle batches (cifar-10-batches-py /
cifar-100-python) from ``data_dir``; ``synthetic=True`` generates the
JAX package's deterministic fake dataset for smoke tests and benches
where the real data is not mounted.  CIFAR-C: 50k-row <corruption>.npy +
labels.npy (5 severities × 10k, evaluated as one pool — cifar.py:292-312).
The loader yields the JAX loader's batches bit for bit (same seeds, same
draws in the same order), in every mode, its AugMix modes serially or
through a pool of worker processes.
"""
from __future__ import annotations

import functools
import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from .augmix import augmix
from .transforms import (cifar_eval_transform, cifar_train_geom,
                         cifar_train_transform, normalize, skip_cifar_train,
                         skip_cifar_train_geom)
from ..parallel.distributed import shard_range
from .workers import PrefetchPool

__all__ = ["CifarData", "load_cifar", "load_cifar_c", "CifarLoader",
           "CORRUPTIONS"]

CORRUPTIONS = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog",
    "brightness", "contrast", "elastic_transform", "pixelate",
    "jpeg_compression",
)

_MODES = ("train", "train_geom", "train_augmix", "train_augmix_nojsd",
          "eval")


@dataclass
class CifarData:
    images: np.ndarray  # (N, 32, 32, 3) uint8
    labels: np.ndarray  # (N,) int32
    num_classes: int


def pad_rows(images: np.ndarray, labels: np.ndarray, rows: int,
             label: int):
    """``images`` and ``labels`` padded to ``rows`` rows with zero images
    and ``label`` (a rank's share of a short last batch)."""
    n = rows - len(labels)
    if n <= 0:
        return images, labels
    return (np.concatenate([images, np.zeros((n,) + images.shape[1:],
                                             images.dtype)]),
            np.concatenate([labels, np.full((n,) + labels.shape[1:], label,
                                            labels.dtype)]))


def _load_pickle(path: str) -> dict:
    # the dataset's own files, in the layout the CIFAR site publishes
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar(data_dir: str, dataset: str = "cifar10", train: bool = True,
               synthetic: bool = False, synthetic_size: int = 512) -> CifarData:
    num_classes = 10 if dataset.replace("-", "") == "cifar10" else 100
    if synthetic:
        rng = np.random.RandomState(0 if train else 1)
        n = synthetic_size
        return CifarData(rng.randint(0, 256, (n, 32, 32, 3), np.uint8),
                         rng.randint(0, num_classes, n).astype(np.int32),
                         num_classes)

    if num_classes == 10:
        base = os.path.join(data_dir, "cifar-10-batches-py")
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        images, labels = [], []
        for fn in files:
            d = _load_pickle(os.path.join(base, fn))
            images.append(d["data"])
            labels.extend(d["labels"])
        data = np.concatenate(images)
    else:
        base = os.path.join(data_dir, "cifar-100-python")
        d = _load_pickle(os.path.join(base, "train" if train else "test"))
        data = d["data"]
        labels = d["fine_labels"]
    images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # → NHWC uint8
    return CifarData(np.ascontiguousarray(images),
                     np.asarray(labels, np.int32), num_classes)


def load_cifar_c(corrupt_dir: str,
                 corruption: str) -> Tuple[np.ndarray, np.ndarray]:
    images = np.load(os.path.join(corrupt_dir, corruption + ".npy"))
    labels = np.load(os.path.join(corrupt_dir, "labels.npy")).astype(np.int32)
    return images, labels


def _augmix_views(item, aug_kw, nojsd):
    """One image's views from (uint8 image, seed): the flip/crop geometry,
    then (clean, AugMix, AugMix), or one AugMix view under ``nojsd``.  At
    module level, so that the serial path and the pool's workers run the
    same function (equal bits per seed)."""
    im, seed = item
    rng = np.random.RandomState(seed)
    geom = cifar_train_geom(rng, im)
    if nojsd:
        return augmix(rng, geom, normalize, 32, **aug_kw)
    return (cifar_eval_transform(geom),
            augmix(rng, geom, normalize, 32, **aug_kw),
            augmix(rng, geom, normalize, 32, **aug_kw))


class CifarLoader:
    """Host-side batch iterator producing NHWC arrays.

    mode:
      'train'      — crop/flip/normalize, float32 (cifar.py:325-330)
      'train_geom' — flip/crop only, uint8 (the input of on-device AugMix)
      'train_augmix'       — flip/crop, then the views (clean, AugMix,
                             AugMix), float32 (3, B, H, W, C)
      'train_augmix_nojsd' — one AugMix view, float32 (the reference's
                             AugMixDataset no_jsd, utils.py:112-113)
      'eval'       — normalize only, float32, in order

    Each pass draws from ``RandomState(seed + epoch * 1009)``, the epoch
    counting the passes made; the training modes drop the last partial
    batch unless ``drop_last`` says otherwise.  An AugMix mode draws one
    seed per image, and ``workers`` > 0 builds the views in that many
    worker processes (``PrefetchPool``), one batch ahead, with the same
    bits as ``workers`` = 0; the pool lives until ``close()``, after which
    the loader builds them serially.

    ``shard`` = (rank, ranks): the loader of one rank of data
    parallelism, yielding that rank's rows of each batch the loader of
    one process yields, bit for bit: it makes every row's draws and
    transforms its own rows only.  A training batch must divide by the
    ranks; 'eval' pads its last batch to a multiple of them, with zero
    images and label −1 (``evaluation/classify.py``).
    """

    def __init__(self, data: CifarData, batch_size: int, mode: str = "train",
                 seed: int = 0, aug_severity: float = 3,
                 mixture_width: int = 3, mixture_depth: int = -1,
                 all_ops: bool = False, drop_last: Optional[bool] = None,
                 workers: int = 0, shard: Optional[Tuple[int, int]] = None):
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {_MODES}")
        if shard is not None and mode != "eval" and batch_size % shard[1]:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"{shard[1]} ranks")
        self.shard = shard
        self.data = data
        self.batch_size = batch_size
        self.mode = mode
        self.seed = seed
        self.aug_kw = dict(aug_severity=aug_severity,
                           mixture_width=mixture_width,
                           mixture_depth=mixture_depth, all_ops=all_ops)
        self.drop_last = (mode != "eval") if drop_last is None else drop_last
        self.epoch = 0
        self._pool = (PrefetchPool(workers)
                      if workers > 0 and mode.startswith("train_augmix")
                      else None)

    def __len__(self):
        n = len(self.data.images)
        b = self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def close(self):
        """Stop the AugMix worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _augmix_batches(self, rng, idx, stop):
        b = self.batch_size
        nojsd = self.mode.endswith("nojsd")
        fn = functools.partial(_augmix_views, aug_kw=self.aug_kw,
                               nojsd=nojsd)

        def items():
            for s in range(0, stop, b):
                sel = idx[s:s + b]
                seeds = rng.randint(0, 2**31, len(sel))
                lo, hi, _ = self._rows(len(sel))
                sel, seeds = sel[lo:hi], seeds[lo:hi]
                yield (list(zip(self.data.images[sel], seeds)),
                       self.data.labels[sel])

        runner = (self._pool.run(fn, items()) if self._pool is not None
                  else (([fn(it) for it in batch], lbl)
                        for batch, lbl in items()))
        for results, labels in runner:
            if nojsd:
                batch = np.stack(results)
            else:
                batch = np.stack([np.stack(v) for v in zip(*results)])
            yield batch.astype(np.float32), labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + self.epoch * 1009)
        self.epoch += 1
        n = len(self.data.images)
        idx = rng.permutation(n) if self.mode != "eval" else np.arange(n)
        b = self.batch_size
        stop = (n // b) * b if self.drop_last else n
        if self.mode.startswith("train_augmix"):
            yield from self._augmix_batches(rng, idx, stop)
            return
        shape = self.data.images.shape[1:3]
        for s in range(0, stop, b):
            sel = idx[s:s + b]
            lo, hi, rows = self._rows(len(sel))
            imgs = self.data.images[sel]
            labels = self.data.labels[sel[lo:hi]]
            if self.mode == "train":
                batch = np.stack([
                    cifar_train_transform(rng, im) if lo <= i < hi
                    else skip_cifar_train(rng, shape)
                    for i, im in enumerate(imgs)][lo:hi])
            elif self.mode == "train_geom":
                yield np.stack([
                    cifar_train_geom(rng, im) if lo <= i < hi
                    else skip_cifar_train_geom(rng, shape)
                    for i, im in enumerate(imgs)][lo:hi]), labels
                continue
            else:
                batch = np.stack([cifar_eval_transform(im)
                                  for im in imgs[lo:hi]] or
                                 [np.zeros(imgs.shape[1:], np.float32)])[
                    :hi - lo]
                if hi - lo < rows:
                    batch, labels = pad_rows(batch, labels, rows, -1)
            yield batch.astype(np.float32), labels

    def _rows(self, n: int):
        """(start, stop, rows) of this loader's rows of a batch of n."""
        if self.shard is None:
            return 0, n, n
        return shard_range(n, *self.shard)
