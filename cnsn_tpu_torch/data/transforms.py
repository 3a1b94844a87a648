"""NumPy image transforms of the CIFAR recipes: port of the CIFAR half of
``cnsn_tpu/data/transforms.py``, matching the reference torchvision stack.

CIFAR train: RandomCrop(32, padding=4) with zero padding +
RandomHorizontalFlip + Normalize([0.5]*3, [0.5]*3) (cifar.py:321-335).
Every function takes a uint8 HWC array and returns float32 HWC
(channels last), or uint8 for the geometry-only AugMix variant.  The
ImageNet transforms (PIL) come with the ImageNet loader (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np

__all__ = ["normalize", "random_crop_pad", "random_hflip",
           "cifar_train_transform", "cifar_train_geom",
           "cifar_eval_transform"]


def normalize(x_uint8: np.ndarray, mean=0.5, std=0.5) -> np.ndarray:
    x = x_uint8.astype(np.float32) / 255.0
    return (x - mean) / std


def random_crop_pad(rng: np.random.RandomState, img: np.ndarray,
                    size: int = 32, pad: int = 4) -> np.ndarray:
    """torchvision RandomCrop(size, padding=pad) with zero padding."""
    padded = np.zeros((img.shape[0] + 2 * pad, img.shape[1] + 2 * pad,
                       img.shape[2]), img.dtype)
    padded[pad:pad + img.shape[0], pad:pad + img.shape[1]] = img
    i = rng.randint(0, padded.shape[0] - size + 1)
    j = rng.randint(0, padded.shape[1] - size + 1)
    return padded[i:i + size, j:j + size]


def random_hflip(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    if rng.rand() < 0.5:
        return img[:, ::-1]
    return img


def cifar_train_transform(rng: np.random.RandomState,
                          img: np.ndarray) -> np.ndarray:
    """Crop → flip → normalize (cifar.py:325-330). Returns float32 HWC."""
    img = random_crop_pad(rng, img)
    img = random_hflip(rng, img)
    return normalize(img)


def cifar_train_geom(rng: np.random.RandomState,
                     img: np.ndarray) -> np.ndarray:
    """Geometric part only — flip → crop, the AugMix variant
    (cifar.py:321-323). Returns uint8 HWC."""
    img = random_hflip(rng, img)
    return np.ascontiguousarray(random_crop_pad(rng, img))


def cifar_eval_transform(img: np.ndarray) -> np.ndarray:
    return normalize(img)
