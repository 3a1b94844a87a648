"""NumPy/PIL image transforms: port of ``cnsn_tpu/data/transforms.py``,
matching the reference torchvision stack.

CIFAR train: RandomCrop(32, padding=4) with zero padding +
RandomHorizontalFlip + Normalize([0.5]*3, [0.5]*3) (cifar.py:321-335).
ImageNet train: RandomResizedCrop(224) + flip + Normalize(ImageNet mean
and std) (imagenet.py:458-473); eval: Resize(256) + CenterCrop(224).
The array functions take a uint8 HWC array and return float32 HWC
(channels last), or uint8 for the geometry-only AugMix variant; the
geometric ImageNet ops take and return PIL images.  The same numpy and
PIL calls as the JAX package's, so the bytes are the same.
"""
from __future__ import annotations

import math

import numpy as np
from PIL import Image

__all__ = ["normalize", "random_crop_pad", "random_hflip",
           "cifar_train_transform", "cifar_train_geom", "skip_cifar_train",
           "skip_cifar_train_geom",
           "cifar_eval_transform", "random_resized_crop",
           "center_crop_resize", "imagenet_normalize", "IMAGENET_MEAN",
           "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(x_uint8: np.ndarray, mean=0.5, std=0.5) -> np.ndarray:
    x = x_uint8.astype(np.float32) / 255.0
    return (x - mean) / std


def imagenet_normalize(x_uint8: np.ndarray) -> np.ndarray:
    return normalize(x_uint8, IMAGENET_MEAN, IMAGENET_STD)


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


def skip_cifar_train(rng: np.random.RandomState, shape=(32, 32)) -> None:
    """The draws of ``cifar_train_transform`` on an image of ``shape``
    (H, W), without the image: a rank's loader makes them for the rows
    of other ranks."""
    rng.randint(0, shape[0] + 8 - 32 + 1)
    rng.randint(0, shape[1] + 8 - 32 + 1)
    rng.rand()


def skip_cifar_train_geom(rng: np.random.RandomState,
                          shape=(32, 32)) -> None:
    """The draws of ``cifar_train_geom``, without the image."""
    rng.rand()
    rng.randint(0, shape[0] + 8 - 32 + 1)
    rng.randint(0, shape[1] + 8 - 32 + 1)


def cifar_eval_transform(img: np.ndarray) -> np.ndarray:
    return normalize(img)


def random_resized_crop(rng: np.random.RandomState, pil_img: Image.Image,
                        size: int = 224) -> Image.Image:
    """torchvision RandomResizedCrop: scale (0.08, 1.0), ratio (3/4, 4/3),
    10 attempts, then the centre crop."""
    w, h = pil_img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        log_ratio = (math.log(3 / 4), math.log(4 / 3))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch + 1)
            j = rng.randint(0, w - cw + 1)
            return pil_img.resize((size, size), Image.BILINEAR,
                                  box=(j, i, j + cw, i + ch))
    scale = min(w, h)
    i, j = (h - scale) // 2, (w - scale) // 2
    return pil_img.resize((size, size), Image.BILINEAR,
                          box=(j, i, j + scale, i + scale))


def center_crop_resize(pil_img: Image.Image, resize: int = 256,
                       crop: int = 224) -> Image.Image:
    """Resize the short side to ``resize``, then the centre ``crop``²."""
    w, h = pil_img.size
    if w < h:
        nw, nh = resize, int(resize * h / w)
    else:
        nw, nh = int(resize * w / h), resize
    img = pil_img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - crop) // 2, (nh - crop) // 2
    return img.crop((left, top, left + crop, top + crop))
