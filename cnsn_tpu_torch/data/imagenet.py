"""ImageNet and ImageNet-C image folders, and the host loader that decodes
and augments them with PIL: port of ``cnsn_tpu/data/imagenet.py``.

The reference's torchvision ImageFolder (imagenet.py:482-505 train and
val; :426-450 an ImageNet-C folder per corruption and severity), with a
scanner of its own and a pool of threads (or, for host AugMix, of
processes) that decode and augment each batch into NHWC float32 (or
uint8, the geometry alone, for on-device AugMix).  The
batches are the JAX loader's bit for bit on its PIL path (same seeds,
same draws in the same order).  The JAX loader's native C++ decoder
(``data/native.py``, linked against libjpeg) has no counterpart: PIL's
wheel carries its own JPEG codec.
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

from .augmix import augmix
from .transforms import (center_crop_resize, imagenet_normalize,
                         random_resized_crop)
from .workers import PrefetchPool

__all__ = ["ImageFolderData", "scan_image_folder", "ImageNetLoader",
           "imagenet_c_dir"]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
_MODES = ("train", "train_augmix", "train_geom", "eval")


@dataclass
class ImageFolderData:
    samples: List[Tuple[str, int]]
    classes: List[str]


def scan_image_folder(root: str) -> ImageFolderData:
    """A folder per class under ``root``, the classes sorted, the images
    of each class (torchvision's extensions) in sorted order of their
    paths, subfolders included."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    samples = []
    for idx, c in enumerate(classes):
        for dirpath, _, files in sorted(os.walk(os.path.join(root, c))):
            for fn in sorted(files):
                if fn.lower().endswith(_EXTS):
                    samples.append((os.path.join(dirpath, fn), idx))
    return ImageFolderData(samples, classes)


def imagenet_c_dir(corrupt_root: str, corruption: str,
                   severity: int) -> str:
    """ImageNet-C's folder of one corruption at one severity (1–5)."""
    return os.path.join(corrupt_root, corruption, str(severity))


def _decode(path: str) -> Image.Image:
    with Image.open(path) as im:
        return im.convert("RGB")


def _train_geometry(rng, path: str, image_size: int) -> np.ndarray:
    """Decode, RandomResizedCrop, then a flip at ``rng.rand() < 0.5``:
    the training geometry of every train mode, uint8 (S, S, 3)."""
    img = random_resized_crop(rng, _decode(path), image_size)
    arr = np.asarray(img, np.uint8)
    if rng.rand() < 0.5:
        arr = np.ascontiguousarray(arr[:, ::-1])
    return arr


def _augmix_item(item, image_size, aug_kw):
    """One image's three views from (path, seed): the training geometry,
    then (clean, AugMix, AugMix) (imagenet.py:487-499).  At module level,
    so that the threads and the worker processes run the same function
    (equal bits per seed)."""
    path, seed = item
    rng = np.random.RandomState(seed)
    arr = _train_geometry(rng, path, image_size)
    return (imagenet_normalize(arr),
            augmix(rng, arr, imagenet_normalize, image_size, **aug_kw),
            augmix(rng, arr, imagenet_normalize, image_size, **aug_kw))


class ImageNetLoader:
    """Batches of an image folder: NHWC images (float32; uint8 in
    'train_geom') and int32 labels.

    mode:
      'train'        — RandomResizedCrop + flip + normalize (B, S, S, 3)
      'train_augmix' — the same geometry, then the views (clean, AugMix,
                       AugMix) at severity ``aug_severity``: (3, B, S, S, 3)
      'train_geom'   — the same geometry only, uint8 (B, S, S, 3): the
                       input of on-device AugMix (``augmix_device.py``)
      'eval'         — resize 256 + centre crop S + normalize, in order

    Each pass draws from ``RandomState(seed + epoch * 1009)``, the epoch
    counting the passes made: a permutation, then in 'train' and
    'train_geom' one ``RandomState(rng.randint(2**31))`` per image, in
    'train_augmix' ``rng.randint(0, 2**31, B)`` per batch.  ``workers``
    threads decode and augment; ``mp_workers`` > 0 builds 'train_augmix'
    views in that many worker processes instead (``PrefetchPool``: the
    PIL op chain holds the GIL), one batch ahead, with the same bits.  The
    pool lives until ``close()``, after which the threads build the
    views.
    """

    def __init__(self, data: ImageFolderData, batch_size: int,
                 mode: str = "train", seed: int = 0, image_size: int = 224,
                 workers: int = 8, aug_severity: float = 1,
                 mixture_width: int = 3, mixture_depth: int = -1,
                 all_ops: bool = False, drop_last: Optional[bool] = None,
                 mp_workers: int = 0):
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {_MODES}")
        self.data = data
        self.batch_size = batch_size
        self.mode = mode
        self.seed = seed
        self.image_size = image_size
        self.workers = workers
        self.aug_kw = dict(aug_severity=aug_severity,
                           mixture_width=mixture_width,
                           mixture_depth=mixture_depth, all_ops=all_ops)
        self.drop_last = (mode != "eval") if drop_last is None else drop_last
        self.epoch = 0
        self._pool = (PrefetchPool(mp_workers)
                      if mp_workers > 0 and mode == "train_augmix" else None)

    def __len__(self):
        n, b = len(self.data.samples), self.batch_size
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

    def _one_train(self, rng, path):
        return imagenet_normalize(self._one_train_geom(rng, path))

    def _one_train_geom(self, rng, path):
        return _train_geometry(rng, path, self.image_size)

    def _one_eval(self, _rng, path):
        img = center_crop_resize(_decode(path), 256, self.image_size)
        return imagenet_normalize(np.asarray(img, np.uint8))

    def _labels(self, sel) -> np.ndarray:
        return np.asarray([self.data.samples[i][1] for i in sel], np.int32)

    def _augmix_batches(self, rng, idx, stop):
        b = self.batch_size
        fn = functools.partial(_augmix_item, image_size=self.image_size,
                               aug_kw=self.aug_kw)

        def items():
            for s in range(0, stop, b):
                sel = idx[s:s + b]
                seeds = rng.randint(0, 2**31, len(sel))
                yield ([(self.data.samples[i][0], sd)
                        for i, sd in zip(sel, seeds)], self._labels(sel))

        def assemble(results):
            return np.stack([np.stack(v)
                             for v in zip(*results)]).astype(np.float32)

        if self._pool is not None:
            for results, labels in self._pool.run(fn, items()):
                yield assemble(results), labels
            return
        with ThreadPoolExecutor(self.workers) as pool:
            for batch, labels in items():
                yield assemble(list(pool.map(fn, batch))), labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + self.epoch * 1009)
        self.epoch += 1
        n = len(self.data.samples)
        idx = rng.permutation(n) if self.mode != "eval" else np.arange(n)
        b = self.batch_size
        stop = (n // b) * b if self.drop_last else n
        if self.mode == "train_augmix":
            yield from self._augmix_batches(rng, idx, stop)
            return
        fn = {"train": self._one_train, "train_geom": self._one_train_geom,
              "eval": self._one_eval}[self.mode]
        with ThreadPoolExecutor(self.workers) as pool:
            for s in range(0, stop, b):
                sel = idx[s:s + b]
                paths = [self.data.samples[i][0] for i in sel]
                rngs = [np.random.RandomState(rng.randint(2**31))
                        for _ in sel]
                batch = np.stack(list(pool.map(fn, rngs, paths)))
                if self.mode != "train_geom":  # which stays uint8
                    batch = batch.astype(np.float32)
                yield batch, self._labels(sel)
