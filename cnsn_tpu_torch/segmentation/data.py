"""Segmentation data: list-file datasets and paired image/label
transforms, a port of ``cnsn_tpu/segmentation/data.py`` without OpenCV.

The JAX module calls cv2 (reference segmentation/util/transform.py:11-239).
Here each op is rewritten in numpy and torch (CPU) to cv2's semantics,
and each transform draws from the host ``RandomState`` in the JAX order,
so batches can be compared:

  * linear resize (``cv2.resize`` INTER_LINEAR on float32): half-pixel
    source coordinates in float64, their fraction rounded to float32 as
    the weight, clamped at the edges; a horizontal pass, then a vertical
    one.  With ``fx``/``fy`` given, cv2 takes the output size
    ``round(w·fx)`` and the source step ``1/fx``; with a size,
    ``1/(W/w)``;
  * nearest resize (INTER_NEAREST): source index ``floor(x·step)`` in
    float64, capped at the last pixel, no half pixel;
  * rotation (``getRotationMatrix2D`` at (w/2, h/2), ``warpAffine`` with a
    constant border): the image's source coordinates as OpenCV 5's float
    kernel takes them, ``fma(m0, x, fma(m1, y, m2))`` in float32 with the
    inverted matrix rounded to float32, and a bilinear lerp in float32;
    the label's through OpenCV's fixed point (AB_BITS 10, rounded), which
    both OpenCV 4 and 5 use for INTER_NEAREST;
  * blur (``GaussianBlur((r, r), 0)`` at any odd r): OpenCV's taps
    (``gaussian_taps``: its fixed tables up to 9 taps, else the
    sigma-derived kernel), rows then columns, BORDER_REFLECT_101 (also
    where r exceeds the image); a row as OpenCV's symmetric small filter
    (r ≤ 5) or its fused multiply-add row filter, a column as its
    symmetric fused multiply-add column filter, each FMA emulated in
    float64: bit for bit up to 3 taps, within 2 float32 ulps of the
    0–255 scale beyond;
  * flips, the constant-border padding of ``Crop`` and ``Normalize``:
    exact.

Images are decoded with PIL (RGB, and the label as an 8-bit grey map),
where the JAX package uses ``cv2.imread``.
"""
from __future__ import annotations

import fractions
import math
import os
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.distributed import shard_range

__all__ = [
    "SegSample", "SegDataset", "SegLoader", "Compose", "Resize", "RandScale",
    "Crop", "RandRotate", "RandomHorizontalFlip", "RandomVerticalFlip",
    "RandomGaussianBlur", "Normalize", "make_list_dataset",
    "synthetic_seg_dataset",
]

_F32 = np.float32
# OpenCV's fixed point for INTER_NEAREST warps (imgproc/src/imgwarp.cpp)
_AB_BITS = 10
_AB_SCALE = 1 << _AB_BITS
# getGaussianKernel's fixed tables for an odd kernel at sigma <= 0
# (imgproc/src/smooth.dispatch.cpp, getGaussianKernelBitExact)
_GAUSS_TABLES = {
    1: (1.0,), 3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: tuple(v / 256 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4))}
# the widest kernel OpenCV's row filter takes symmetrically
_SYMM_ROW = 5


# ---- the cv2 ops ----------------------------------------------------------

def _out_size(n: int, f: float) -> int:
    # saturate_cast<int>(n·f): round half to even
    return int(np.rint(n * f))


def _linear_taps(out_n: int, in_n: int, step: float):
    """Source index and float32 weights of each output position along one
    axis of a linear resize (``resize`` in imgproc/src/resize.cpp)."""
    src = (np.arange(out_n) + 0.5) * step - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = (src - i0).astype(_F32)
    low = i0 < 0
    f[low], i0[low] = 0, 0
    high = i0 >= in_n - 1
    f[high], i0[high] = 0, in_n - 1
    i1 = np.minimum(i0 + 1, in_n - 1)
    return (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.from_numpy(1 - f), torch.from_numpy(f))


def _resize_linear(image: np.ndarray, out_h: int, out_w: int,
                   step_y: float, step_x: float) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(image, _F32))
    i0, i1, a0, a1 = _linear_taps(out_w, x.shape[1], step_x)
    x = (x.index_select(1, i0) * a0[None, :, None]
         + x.index_select(1, i1) * a1[None, :, None])
    i0, i1, a0, a1 = _linear_taps(out_h, x.shape[0], step_y)
    x = (x.index_select(0, i0) * a0[:, None, None]
         + x.index_select(0, i1) * a1[:, None, None])
    return x.numpy()


def _resize_nearest(label: np.ndarray, out_h: int, out_w: int,
                    step_y: float, step_x: float) -> np.ndarray:
    h, w = label.shape
    ys = np.minimum(np.floor(np.arange(out_h) * step_y).astype(np.int64),
                    h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * step_x).astype(np.int64),
                    w - 1)
    return np.ascontiguousarray(label[ys[:, None], xs[None, :]])


def _resize(image, label, out_h, out_w, step_y, step_x):
    return (_resize_linear(image, out_h, out_w, step_y, step_x),
            _resize_nearest(label, out_h, out_w, step_y, step_x))


def rotation_matrix(center: Tuple[float, float], angle: float,
                    scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` (warpAffine without
    WARP_INVERSE_MAP inverts its matrix this way)."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _fma32(a, b, c):
    """a·b + c rounded once to float32 (float32 operands: the product is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _warp_linear(image: np.ndarray, minv: np.ndarray,
                 border: Sequence[float]) -> np.ndarray:
    h, w, ch = image.shape
    m = torch.from_numpy(minv.astype(_F32))
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)

    def coord(r):
        inner = _fma32(m[r, 1].expand(h, w), ys, m[r, 2].expand(h, w))
        return _fma32(m[r, 0].expand(h, w), xs, inner)

    sx, sy = coord(0), coord(1)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    src = torch.from_numpy(np.ascontiguousarray(image, _F32)).reshape(-1, ch)
    cval = torch.tensor(np.asarray(border, _F32))

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)
        v = src.index_select(0, idx).reshape(h, w, ch)
        return torch.where(inside[..., None], v, cval)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    v0 = p00 + fx * (p01 - p00)
    v1 = p10 + fx * (p11 - p10)
    return (v0 + fy * (v1 - v0)).numpy()


def _warp_nearest(label: np.ndarray, minv: np.ndarray,
                  border: int) -> np.ndarray:
    h, w = label.shape
    ys, xs = np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64)
    half = _AB_SCALE // 2
    x_row = np.rint((minv[0, 1] * ys + minv[0, 2]) * _AB_SCALE).astype(
        np.int64) + half
    y_row = np.rint((minv[1, 1] * ys + minv[1, 2]) * _AB_SCALE).astype(
        np.int64) + half
    x_col = np.rint(minv[0, 0] * xs * _AB_SCALE).astype(np.int64)
    y_col = np.rint(minv[1, 0] * xs * _AB_SCALE).astype(np.int64)
    sx = (x_row[:, None] + x_col[None, :]) >> _AB_BITS
    sy = (y_row[:, None] + y_col[None, :]) >> _AB_BITS
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = label[np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)]
    return np.where(inside, out, np.asarray(border, label.dtype))


def gaussian_taps(r: int) -> np.ndarray:
    """``cv2.getGaussianKernel(r, 0, CV_32F)``: a fixed table up to 9
    taps, else exp(−x²/(2σ²)) at σ = 0.3·((r − 1)/2 − 1) + 0.8 in double,
    normalised to sum 1, rounded to float32.  An even or non-positive r
    raises, as OpenCV's GaussianBlur does."""
    if r < 1 or r % 2 == 0:
        raise ValueError(f"Gaussian blur radius {r}: a positive odd size")
    if r in _GAUSS_TABLES:
        return np.array(_GAUSS_TABLES[r], _F32)
    # σ = 0.15·r + 0.35, rounded once (OpenCV's mulAdd)
    sigma = float(fractions.Fraction(r) * fractions.Fraction(0.15)
                  + fractions.Fraction(0.35))
    scale = -0.125 / (sigma * sigma)  # −1/(2σ²) on x = 2·(i − (r−1)/2)
    side = [math.exp(float(x * x) * scale) for x in range(1 - r, 0, 2)]
    total = 0.0
    for v in side:
        total += v
    inv = 1.0 / (total * 2 + 1.0)
    side = [v * inv for v in side]
    return np.array(side + [inv] + side[::-1], _F32)


def _fma_round(a: torch.Tensor, k: float, acc: torch.Tensor) -> torch.Tensor:
    """float32(a·k + acc) for float32 values held in float64: the product
    is exact there, so one rounding as a fused multiply-add makes."""
    return (a * k + acc).to(torch.float32).to(torch.float64)


def _blur_axis(x: torch.Tensor, k: np.ndarray, dim: int,
               symmetric_rows: bool) -> torch.Tensor:
    """One pass of the separable blur along ``dim`` of a float32 image
    held in float64, BORDER_REFLECT_101."""
    r = len(k)
    p, n = r // 2, x.shape[dim]
    xp = x.index_select(dim, _reflect101(n, p))

    def tap(i):
        return xp.narrow(dim, i, n)

    def f32(t):
        return t.to(torch.float32).to(torch.float64)

    if dim == 0 or symmetric_rows:
        # the centre, then each pair of taps summed first
        acc = f32(tap(p) * float(k[p]))
        for j in range(1, p + 1):
            pair = f32(tap(p - j) + tap(p + j))
            acc = (_fma_round(pair, float(k[p + j]), acc) if dim == 0
                   else f32(acc + f32(pair * float(k[p + j]))))
        return acc
    acc = f32(tap(0) * float(k[0]))
    for i in range(1, r):
        acc = _fma_round(tap(i), float(k[i]), acc)
    return acc


def _gaussian_blur(image: np.ndarray, r: int) -> np.ndarray:
    """``cv2.GaussianBlur(image, (r, r), 0)`` of a float32 HWC image."""
    k = gaussian_taps(r)
    x = torch.from_numpy(np.ascontiguousarray(image, _F32)).to(torch.float64)
    x = _blur_axis(x, k, 1, r <= _SYMM_ROW)
    x = _blur_axis(x, k, 0, True)
    return x.to(torch.float32).numpy()


def _reflect101(n: int, pad: int) -> torch.Tensor:
    idx = np.arange(-pad, n + pad)
    period = 2 * (n - 1) if n > 1 else 1
    idx = np.abs(idx) % period
    idx = np.where(idx >= n, period - idx, idx)
    return torch.from_numpy(idx.astype(np.int64))


# ---- paired transforms (callable(rng, image f32 HWC, label i32 HW)) -----

# Each transform's ``skip(rng, hw)`` makes the draws its call makes on an
# image of size hw and returns the size of its output, without the image:
# a rank's loader makes them for the rows of other ranks.

class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = transforms

    def __call__(self, rng, image, label):
        for t in self.transforms:
            image, label = t(rng, image, label)
        return image, label

    def skip(self, rng, hw):
        for t in self.transforms:
            hw = t.skip(rng, hw)
        return hw


class Resize:
    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (h, w)

    def skip(self, rng, hw):
        return self.size

    def __call__(self, rng, image, label):
        h, w = self.size
        ih, iw = label.shape
        return _resize(image, label, h, w, 1.0 / (h / ih), 1.0 / (w / iw))


class RandScale:
    def __init__(self, scale: Tuple[float, float],
                 aspect_ratio: Optional[Tuple[float, float]] = None):
        self.scale = scale
        self.aspect_ratio = aspect_ratio

    def _factors(self, rng):
        s = self.scale[0] + (self.scale[1] - self.scale[0]) * rng.rand()
        ar_h = ar_w = 1.0
        if self.aspect_ratio is not None:
            ar = (self.aspect_ratio[0]
                  + (self.aspect_ratio[1] - self.aspect_ratio[0]) * rng.rand())
            ar = ar ** 0.5
            ar_h, ar_w = ar, 1.0 / ar
        return s * ar_w, s * ar_h

    def __call__(self, rng, image, label):
        fx, fy = self._factors(rng)
        h, w = label.shape
        return _resize(image, label, _out_size(h, fy), _out_size(w, fx),
                       1.0 / fy, 1.0 / fx)

    def skip(self, rng, hw):
        fx, fy = self._factors(rng)
        return _out_size(hw[0], fy), _out_size(hw[1], fx)


class Crop:
    """Random/center crop to (h, w), padding short sides with the image
    mean / ignore_label (reference transform.py Crop)."""

    def __init__(self, size: Tuple[int, int], crop_type: str = "rand",
                 padding: Optional[Sequence[float]] = None,
                 ignore_label: int = 255):
        self.size = size
        self.crop_type = crop_type
        self.padding = padding or (0.0, 0.0, 0.0)
        self.ignore_label = ignore_label

    def __call__(self, rng, image, label):
        ch, cw = self.size
        h, w = label.shape
        pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
        if pad_h > 0 or pad_w > 0:
            t, b = pad_h // 2, pad_h - pad_h // 2
            l, r = pad_w // 2, pad_w - pad_w // 2
            padded = np.empty((h + pad_h, w + pad_w, image.shape[2]),
                              image.dtype)
            padded[...] = np.asarray(self.padding, image.dtype)
            padded[t:t + h, l:l + w] = image
            image = padded
            label = np.pad(label, ((t, b), (l, r)), constant_values=(
                self.ignore_label))
            h, w = label.shape
        if self.crop_type == "rand":
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
        else:
            y, x = (h - ch) // 2, (w - cw) // 2
        return (image[y:y + ch, x:x + cw],
                np.ascontiguousarray(label[y:y + ch, x:x + cw]))

    def skip(self, rng, hw):
        ch, cw = self.size
        h, w = max(hw[0], ch), max(hw[1], cw)
        if self.crop_type == "rand":
            rng.randint(0, h - ch + 1)
            rng.randint(0, w - cw + 1)
        return ch, cw


class RandRotate:
    def __init__(self, rotate: Tuple[float, float],
                 padding: Sequence[float], ignore_label: int = 255,
                 p: float = 0.5):
        self.rotate = rotate
        self.padding = padding
        self.ignore_label = ignore_label
        self.p = p

    def __call__(self, rng, image, label):
        if rng.rand() < self.p:
            angle = self.rotate[0] + (self.rotate[1] - self.rotate[0]) * rng.rand()
            h, w = label.shape
            minv = _invert_affine(rotation_matrix((w / 2, h / 2), angle, 1))
            image = _warp_linear(image, minv, self.padding)
            label = _warp_nearest(label, minv, self.ignore_label)
        return image, label

    def skip(self, rng, hw):
        if rng.rand() < self.p:
            rng.rand()
        return hw


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng, image, label):
        if rng.rand() < self.p:
            return (np.ascontiguousarray(image[:, ::-1]),
                    np.ascontiguousarray(label[:, ::-1]))
        return image, label

    def skip(self, rng, hw):
        rng.rand()
        return hw


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng, image, label):
        if rng.rand() < self.p:
            return (np.ascontiguousarray(image[::-1]),
                    np.ascontiguousarray(label[::-1]))
        return image, label

    def skip(self, rng, hw):
        rng.rand()
        return hw


class RandomGaussianBlur:
    """``cv2.GaussianBlur(image, (radius, radius), 0)`` with probability
    ``p``; an even radius raises when the transform is built."""

    def __init__(self, radius: int = 5, p: float = 0.5):
        gaussian_taps(radius)
        self.radius = radius
        self.p = p

    def __call__(self, rng, image, label):
        if rng.rand() < self.p:
            image = _gaussian_blur(image, self.radius)
        return image, label

    def skip(self, rng, hw):
        rng.rand()
        return hw


class Normalize:
    def __init__(self, mean: Sequence[float], std: Optional[Sequence[float]] = None):
        self.mean = np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, rng, image, label):
        image = image - self.mean
        if self.std is not None:
            image = image / self.std
        return image, label

    def skip(self, rng, hw):
        return hw


# ---- datasets -----------------------------------------------------------

@dataclass
class SegSample:
    image_path: str
    label_path: str


class SegDataset:
    def __init__(self, samples: List[SegSample]):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def size(self, i: int) -> Tuple[int, int]:
        """(H, W) of sample i, read from its label's header."""
        from PIL import Image
        with Image.open(self.samples[i].label_path) as im:
            return im.size[1], im.size[0]

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image
        s = self.samples[i]
        with Image.open(s.image_path) as im:
            image = np.asarray(im.convert("RGB"), np.float32)
        with Image.open(s.label_path) as im:
            label = np.asarray(im if im.mode == "L" else im.convert("L"))
        return image, label.astype(np.int32)


def make_list_dataset(data_root: str, list_path: str) -> SegDataset:
    """'image_path label_path' per line, relative to data_root
    (reference segmentation/util/dataset.py make_dataset)."""
    samples = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 2:
                continue
            samples.append(SegSample(os.path.join(data_root, parts[0]),
                                     os.path.join(data_root, parts[1])))
    if not samples:
        raise RuntimeError(f"no samples in {list_path}")
    return SegDataset(samples)


class _SyntheticSegDataset(SegDataset):
    def __init__(self, n: int, hw: Tuple[int, int], classes: int, seed: int = 0):
        super().__init__([SegSample("", "")] * n)
        self.n, self.hw, self.classes, self.seed = n, hw, classes, seed

    def size(self, i):
        return tuple(self.hw)

    def load(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        image = rng.randint(0, 256, (*self.hw, 3)).astype(np.float32)
        label = rng.randint(0, self.classes, self.hw).astype(np.int32)
        label[:2, :2] = 255  # some ignore pixels
        return image, label


def synthetic_seg_dataset(n: int = 8, hw=(97, 113), classes: int = 19,
                          seed: int = 0) -> SegDataset:
    return _SyntheticSegDataset(n, hw, classes, seed)


class SegLoader:
    """Batch iterator: transform pairs → (B,H,W,3) float32 + (B,H,W) int32.

    ``shard`` = (rank, ranks): one rank's rows of each batch, bit for bit:
    the transforms' draws of the other rows are made by their ``skip``
    (on the sizes the dataset reads from the files' headers), and a
    short last batch is padded to a multiple of the ranks with zero
    images labelled ``pad_label`` throughout."""

    def __init__(self, dataset: SegDataset, batch_size: int,
                 transform: Callable, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True,
                 shard: Optional[Tuple[int, int]] = None,
                 pad_label: int = 255):
        if shard is not None and drop_last and batch_size % shard[1]:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"{shard[1]} ranks")
        self.shard = shard
        self.pad_label = pad_label
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + 1009 * self.epoch)
        self.epoch += 1
        n = len(self.dataset)
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        b = self.batch_size
        stop = (n // b) * b if self.drop_last else n
        for s in range(0, stop, b):
            sel = idx[s:s + b]
            lo, hi, rows = ((0, len(sel), len(sel)) if self.shard is None
                            else shard_range(len(sel), *self.shard))
            images, labels = [], []
            for k, i in enumerate(sel):
                if not lo <= k < hi:
                    self.transform.skip(rng, self.dataset.size(int(i)))
                    continue
                img, lab = self.dataset.load(int(i))
                img, lab = self.transform(rng, img, lab)
                images.append(img)
                labels.append(lab)
            if rows > hi - lo:  # a rank's padding of a short last batch
                shape = self._shape(sel)
                images += [np.zeros(shape + (3,), np.float32)] * (
                    rows - (hi - lo))
                labels += [np.full(shape, self.pad_label, np.int32)] * (
                    rows - (hi - lo))
            yield (np.stack(images).astype(np.float32),
                   np.stack(labels).astype(np.int32))

    def _shape(self, sel):
        """The size the transform gives the batch's first image: the
        padding rows' (the validation transforms draw nothing)."""
        return tuple(self.transform.skip(np.random.RandomState(0),
                                         self.dataset.size(int(sel[0]))))
