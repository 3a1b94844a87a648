"""Class-major matrix upsampling and the fused cross-entropy of the
segmentation heads: port of ``cnsn_tpu/segmentation/upsample.py``.

The head logits (B, h, w, K) at output stride 8 are upsampled to the
label size as two matrix products with 2-tap interpolation matrices, the
class axis a batch dimension, and the masked cross-entropy is taken
there: logsumexp over the classes minus the logit of the label, summed
over the non-ignored pixels.  The matrices reproduce ``jax.image.resize
'bilinear'`` (torch ``F.interpolate(align_corners=False)``), or
``align_corners=True``.  The JAX package has no kernel here; both
products are plain matrix products.

The JAX functions compute in float32 whatever the logits' type; these
compute in at least float32 (float64 logits stay float64), and the
matrices' entries are the JAX package's float32 values.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["bilinear_matrix", "upsample_nll_sum", "upsample_argmax"]


@functools.lru_cache(maxsize=32)
def bilinear_matrix(out_size: int, in_size: int,
                    align_corners: bool = False) -> np.ndarray:
    """(out, in) fp32 interpolation matrix reproducing
    jax.image.resize 'bilinear' (half-pixel centers, edge clamp), or
    — with ``align_corners=True`` — torch
    F.interpolate(align_corners=True) as used by the PSP/PSA heads.

    Upscale only: resize antialiases (widens the triangle) when
    downscaling, which a 2-tap matrix does not reproduce."""
    if out_size < in_size:
        raise ValueError(f"upscale only ({in_size} -> {out_size})")
    if align_corners:
        src = (np.linspace(0.0, in_size - 1.0, out_size)
               if out_size > 1 else np.zeros(1))
    else:
        scale = in_size / out_size
        src = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(src)
    f = src - x0
    m = np.zeros((out_size, in_size), np.float32)
    lo = np.clip(x0.astype(np.int64), 0, in_size - 1)
    hi = np.clip(x0.astype(np.int64) + 1, 0, in_size - 1)
    np.add.at(m, (np.arange(out_size), lo), (1.0 - f).astype(np.float32))
    np.add.at(m, (np.arange(out_size), hi), f.astype(np.float32))
    return m


def _matrix(out_size, in_size, align_corners, like: torch.Tensor):
    m = bilinear_matrix(out_size, in_size, align_corners)
    return torch.from_numpy(m).to(device=like.device, dtype=like.dtype)


def _upsample_cmajor(logits_lr: torch.Tensor, out_h: int, out_w: int,
                     align_corners: bool = False) -> torch.Tensor:
    """(B, h, w, K) low-res logits → (B, K, H, W) class-major high-res."""
    _, h, w, _ = logits_lr.shape
    z = logits_lr.permute(0, 3, 1, 2)
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    ah = _matrix(out_h, h, align_corners, z)
    aw = _matrix(out_w, w, align_corners, z)
    z = torch.einsum("Hh,bkhw->bkHw", ah, z)
    return torch.einsum("Ww,bkHw->bkHW", aw, z)


def upsample_nll_sum(logits_lr: torch.Tensor, labels: torch.Tensor,
                     ignore_label: int = 255, align_corners: bool = False):
    """(nll_sum, valid_count) of CE(upsample(logits), labels): equal to
    ``masked_nll_sum`` on the resized (B, H, W, K) logits, without a
    class-minor full-resolution tensor.  labels: (B, H, W) integers."""
    _, out_h, out_w = labels.shape
    z = _upsample_cmajor(logits_lr, out_h, out_w, align_corners)
    zmax = z.amax(dim=1, keepdim=True)
    lse = torch.log(torch.exp(z - zmax).sum(dim=1)) + zmax[:, 0]
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    z_label = z.gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, lse - z_label, 0.0)
    return nll.sum(), valid.sum()


def upsample_argmax(logits_lr: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """argmax over the classes of the upsampled logits, (B, H, W) int64
    (the first of equal maxima, as JAX's)."""
    z = _upsample_cmajor(logits_lr, out_h, out_w, align_corners)
    return z.argmax(dim=1)
