"""AugMix, host side (numpy and PIL): port of ``cnsn_tpu/data/augmix.py``.

The op set and mixture distribution of the reference
(augmentations.py:21-149, utils.py:63-120): 9 default PIL ops (4 more
under ``all_ops``, which overlap ImageNet-C), each op's severity drawn
from U(0.1, level), Dirichlet([1]*width) branch weights, a Beta(1, 1)
skip coefficient and a depth in {1, 2, 3} per branch, the branches mixed
in preprocessed (normalized float) space.  The same draws in the same
order as the JAX package's copy, so the views are equal bit for bit.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

__all__ = ["augmix", "AUGMENTATIONS", "AUGMENTATIONS_ALL"]


def _int_param(level: float, maxval: float) -> int:
    return int(level * maxval / 10)


def _float_param(level: float, maxval: float) -> float:
    return float(level) * maxval / 10.0


def _sample_level(rng, n: float) -> float:
    return rng.uniform(0.1, n)


def _autocontrast(rng, img, _level, _size):
    return ImageOps.autocontrast(img)


def _equalize(rng, img, _level, _size):
    return ImageOps.equalize(img)


def _posterize(rng, img, level, _size):
    level = _int_param(_sample_level(rng, level), 4)
    return ImageOps.posterize(img, 4 - level)


def _rotate(rng, img, level, _size):
    degrees = _int_param(_sample_level(rng, level), 30)
    if rng.uniform() > 0.5:
        degrees = -degrees
    return img.rotate(degrees, resample=Image.BILINEAR)


def _solarize(rng, img, level, _size):
    level = _int_param(_sample_level(rng, level), 256)
    return ImageOps.solarize(img, 256 - level)


def _shear_x(rng, img, level, size):
    level = _float_param(_sample_level(rng, level), 0.3)
    if rng.uniform() > 0.5:
        level = -level
    return img.transform((size, size), Image.AFFINE, (1, level, 0, 0, 1, 0),
                         resample=Image.BILINEAR)


def _shear_y(rng, img, level, size):
    level = _float_param(_sample_level(rng, level), 0.3)
    if rng.uniform() > 0.5:
        level = -level
    return img.transform((size, size), Image.AFFINE, (1, 0, 0, level, 1, 0),
                         resample=Image.BILINEAR)


def _translate_x(rng, img, level, size):
    level = _int_param(_sample_level(rng, level), size / 3)
    if rng.uniform() > 0.5:
        level = -level
    return img.transform((size, size), Image.AFFINE, (1, 0, level, 0, 1, 0),
                         resample=Image.BILINEAR)


def _translate_y(rng, img, level, size):
    level = _int_param(_sample_level(rng, level), size / 3)
    if rng.uniform() > 0.5:
        level = -level
    return img.transform((size, size), Image.AFFINE, (1, 0, 0, 0, 1, level),
                         resample=Image.BILINEAR)


def _color(rng, img, level, _size):
    level = _float_param(_sample_level(rng, level), 1.8) + 0.1
    return ImageEnhance.Color(img).enhance(level)


def _contrast(rng, img, level, _size):
    level = _float_param(_sample_level(rng, level), 1.8) + 0.1
    return ImageEnhance.Contrast(img).enhance(level)


def _brightness(rng, img, level, _size):
    level = _float_param(_sample_level(rng, level), 1.8) + 0.1
    return ImageEnhance.Brightness(img).enhance(level)


def _sharpness(rng, img, level, _size):
    level = _float_param(_sample_level(rng, level), 1.8) + 0.1
    return ImageEnhance.Sharpness(img).enhance(level)


AUGMENTATIONS: Sequence[Callable] = (
    _autocontrast, _equalize, _posterize, _rotate, _solarize,
    _shear_x, _shear_y, _translate_x, _translate_y,
)

AUGMENTATIONS_ALL: Sequence[Callable] = AUGMENTATIONS + (
    _color, _contrast, _brightness, _sharpness,
)


def augmix(
    rng: np.random.RandomState,
    image_uint8: np.ndarray,
    preprocess: Callable[[np.ndarray], np.ndarray],
    image_size: int,
    all_ops: bool = False,
    mixture_width: int = 3,
    mixture_depth: int = -1,
    aug_severity: float = 3,
) -> np.ndarray:
    """One AugMix view of an HWC uint8 image; returns preprocessed float32.

    Reference: utils.py:63-93 ``aug_func``.
    """
    ops = AUGMENTATIONS_ALL if all_ops else AUGMENTATIONS
    ws = np.float32(rng.dirichlet([1] * mixture_width))
    m = np.float32(rng.beta(1, 1))

    base = Image.fromarray(image_uint8)
    mix = np.zeros_like(preprocess(image_uint8), np.float32)
    for i in range(mixture_width):
        img = base.copy()
        depth = mixture_depth if mixture_depth > 0 else rng.randint(1, 4)
        for _ in range(depth):
            op = ops[rng.randint(len(ops))]
            img = op(rng, img, aug_severity, image_size)
        mix += ws[i] * preprocess(np.asarray(img, np.uint8))

    return (1 - m) * preprocess(image_uint8) + m * mix
