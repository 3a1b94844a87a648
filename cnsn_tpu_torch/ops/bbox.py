"""Rejection-sampled bounding boxes for CrossNorm cropping, on the host.

Port of ``cnsn_tpu/ops/bbox.py`` (``_propose``, ``sample_bbox``).  JAX
runs the loop as a ``lax.while_loop`` inside its jitted step; here the box
is drawn on the host from an explicit CPU ``torch.Generator`` and comes
back as Python ints, so slicing by it never waits for the card.  The
distribution is JAX's (checked by a two-sample test):

  * area ratio ~ Beta(beta, beta); side fraction = sqrt(ratio);
  * cut sizes truncate to int (``int(dim * frac)``);
  * centre uniform over the full extent; box clipped to bounds;
  * redraw until the realised (clipped) area ratio > ``bbx_thres``.

Beta is drawn by Jöhnk's method (two uniforms per try), exact for every
beta > 0; the recipes use beta 1, where half the tries are accepted.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["sample_bbox"]

_TRIES = 16  # Jöhnk tries per draw of uniforms: at beta 1, 2^-16 all fail


def _beta(generator: Optional[torch.Generator], beta: float) -> float:
    """One Beta(beta, beta) draw by Jöhnk's method: of uniform pairs
    (u, v), the first with a + b <= 1 for a = u^(1/beta), b = v^(1/beta)
    gives a / (a + b).  Tries are drawn ``_TRIES`` at a time."""
    while True:
        ab = torch.rand(_TRIES, 2, generator=generator,
                        dtype=torch.float64) ** (1.0 / beta)
        total = ab.sum(dim=1)
        for (a, _), t in zip(ab.tolist(), total.tolist()):
            if 0.0 < t <= 1.0:
                return a / t


def _propose(generator: Optional[torch.Generator], h: int, w: int,
             beta: float) -> Tuple[int, int, int, int]:
    frac = _beta(generator, beta) ** 0.5
    cut_h, cut_w = int(h * frac), int(w * frac)
    uh, uw = torch.rand(2, generator=generator, dtype=torch.float64).tolist()
    ch, cw = min(int(uh * h), h - 1), min(int(uw * w), w - 1)
    return (min(max(ch - cut_h // 2, 0), h), min(max(ch + cut_h // 2, 0), h),
            min(max(cw - cut_w // 2, 0), w), min(max(cw + cut_w // 2, 0), w))


def sample_bbox(h: int, w: int, beta: float = 1.0, bbx_thres: float = 0.1,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[int, int, int, int]:
    """One (h1, h2, w1, w2) box shared by the whole batch: rows [h1, h2)
    and columns [w1, w2) of an H×W plane, drawn from ``generator`` (a CPU
    generator; the default one when None)."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("boxes are drawn on the host: pass a CPU "
                         f"generator, not one on {generator.device}")
    while True:
        h1, h2, w1, w2 = box = _propose(generator, h, w, beta)
        if (h2 - h1) * (w2 - w1) / (h * w) > bbx_thres:
            return box
