"""Functional 2-instance CrossNorm (style-statistics transfer).

Port of ``cnsn_tpu/ops/crossnorm.py``: each instance of an NHWC batch
takes the per-channel spatial statistics of a partner drawn by a random
permutation.  ``crop`` selects where the statistics are taken ('style':
inside a random box) and where they are applied ('content': inside
another box, the rest of the plane kept as it was); 'both' does both,
'neither' neither.  ``chan`` shuffles the partner's channels and ``lam``
mixes the result with x, the reference's two dead options, kept for knob
parity.

Every draw can come from the caller: ``perm`` (the partner of each
instance), ``style_box`` and ``content_box`` ((h1, h2, w1, w2) Python
ints) and ``chan_perm``; what is not given is drawn from ``generator``
(``ops/bbox.py`` for the boxes, which need a CPU generator).  A draw made
on the host reaches the card by a pinned, non-blocking copy.  Across
ranks (``parallel/``) every rank draws, or is given, the global batch's
pairing and takes its block, so that no pair crosses ranks where
``num_groups`` is a multiple of the rank count; where a rank's rows are
not one block of the batch the pairing is over (``rows``: AugMix's
views), the pairing stays whole and the partners' statistics are
gathered from every rank.

The unmasked statistics go through ``instance_mean_std`` (K1 on the card)
and are taken once per call where JAX takes them twice (``:103``,
``:120``); the masked ones are plain torch (``stats.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..parallel.distributed import all_gather_rows, global_rows, local_rows
from .bbox import sample_bbox
from .recompute import replayed
from .stats import instance_mean_std, masked_instance_mean_std, region_mask

__all__ = ["CROP_MODES", "cross_norm_2ins", "cross_norm_fma", "draw",
           "grouped_permutation", "instance_norm_mix", "pair_stats"]

CROP_MODES = ("neither", "style", "content", "both")


def instance_norm_mix(content: torch.Tensor, style: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Replace content's per-(N, C) statistics with style's (AdaIN).
    NHWC; spatial sizes may differ, (N, C) must match."""
    if (content.shape[0] != style.shape[0]
            or content.shape[3] != style.shape[3]):
        raise ValueError("content/style must match in (N, C)")
    s_mean, s_std = instance_mean_std(style, eps=eps)
    c_mean, c_std = instance_mean_std(content, eps=eps)
    return (content - c_mean) / c_std * s_std + s_mean


def grouped_permutation(n: int, num_groups: int = 1,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Random permutation of [0, n) that stays within ``num_groups``
    contiguous blocks (per-shard pairing under data parallelism), on the
    generator's device."""
    if n % num_groups != 0:
        raise ValueError(f"batch {n} not divisible by num_groups "
                         f"{num_groups}")
    g = n // num_groups
    device = generator.device if generator is not None else None
    return torch.cat([torch.randperm(g, generator=generator, device=device)
                      + i * g for i in range(num_groups)])


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes to the card through pinned
    memory without waiting for the card's queue."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def draw(x: torch.Tensor, crop: str = "neither", *, beta: float = 1.0,
         bbx_thres: float = 0.1, chan: bool = False, num_groups: int = 1,
         perm: Optional[torch.Tensor] = None,
         style_box: Optional[Sequence[int]] = None,
         content_box: Optional[Sequence[int]] = None,
         chan_perm: Optional[torch.Tensor] = None,
         rows: Optional[torch.Tensor] = None,
         generator: Optional[torch.Generator] = None) -> dict:
    """The draws one CrossNorm call on the NHWC ``x`` uses: of those
    ``crop`` and ``chan`` need, the given ones, and the missing ones
    drawn from ``generator`` (in the order perm, style box, content box,
    channel permutation), the permutations on x's device; None for the
    rest.  ``rows``: on a rank of a group, the index of each of x's rows
    in the global batch the pairing is over, where the ranks' rows
    interleave in it; the pairing is then kept whole (``pair_stats``
    gathers the partners' statistics), else the rank takes its block.  A
    recomputation (``ops/recompute.py``) gets the first run's draws back
    and draws nothing."""
    return replayed(lambda: _draw(
        x, crop, beta, bbx_thres, chan, num_groups, perm, style_box,
        content_box, chan_perm, rows, generator))


def _draw(x, crop, beta, bbx_thres, chan, num_groups, perm, style_box,
          content_box, chan_perm, rows, generator) -> dict:
    if crop not in CROP_MODES:
        raise ValueError(f"crop must be one of {CROP_MODES}, got {crop!r}")
    n, h, w, c = x.shape
    n_global, start = global_rows(n)
    if perm is None:
        perm = grouped_permutation(n_global, num_groups, generator)
    if perm.shape[0] != n and rows is None:
        # across ranks: this rank's block of the global pairing
        perm = local_rows(perm, n) - start
        if perm.device.type == "cpu" and (perm.min() < 0
                                          or perm.max() >= n):
            raise ValueError(
                f"a CrossNorm pair crosses ranks: num_groups {num_groups} "
                "must be a multiple of the rank count")
    if crop in ("style", "both") and style_box is None:
        style_box = sample_bbox(h, w, beta, bbx_thres, generator)
    if crop in ("content", "both") and content_box is None:
        content_box = sample_bbox(h, w, beta, bbx_thres, generator)
    if chan and chan_perm is None:
        device = generator.device if generator is not None else None
        chan_perm = torch.randperm(c, generator=generator, device=device)
    return {"perm": _to_device(perm, x.device),
            "style_box": style_box if crop in ("style", "both") else None,
            "content_box": (content_box if crop in ("content", "both")
                            else None),
            "chan_perm": _to_device(chan_perm, x.device) if chan else None,
            "rows": None if rows is None else _to_device(rows, x.device)}


def pair_stats(x, crop, d, eps, out_dtype=None):
    """((style mean, std), (content mean, std)), each (N, 1, 1, C) in
    ``out_dtype`` (None: x's type), the partner's gathered: masked inside
    a box where ``crop`` asks, else the whole plane's, taken once for
    both roles."""
    masked = {"style": crop in ("style", "both"),
              "content": crop in ("content", "both")}
    whole = (None if all(masked.values())
             else instance_mean_std(x, eps=eps, out_dtype=out_dtype))
    style, content = (
        masked_instance_mean_std(x, d[f"{role}_box"], eps=eps,
                                 out_dtype=out_dtype)
        if masked[role] else whole for role in ("style", "content"))
    if d["rows"] is None:
        style = tuple(s.index_select(0, d["perm"]) for s in style)
    else:
        style = _partners_across_ranks(style, d["perm"], d["rows"])
    if d["chan_perm"] is not None:
        style = tuple(s.index_select(3, d["chan_perm"]) for s in style)
    return style, content


def _partners_across_ranks(stats, perm, rows):
    """Each of this rank's rows (global index ``rows``) takes the
    statistics of its partner ``perm[rows]``, from the statistics and row
    indices of every rank, gathered."""
    where = torch.empty_like(perm)
    where[all_gather_rows(rows)] = torch.arange(perm.numel(),
                                                device=perm.device)
    pick = where.index_select(0, perm.index_select(0, rows))
    return tuple(all_gather_rows(s).index_select(0, pick) for s in stats)


def _content_mask(x, d):
    h1, h2, w1, w2 = d["content_box"]
    return region_mask(x.shape[1], x.shape[2], h1, h2, w1, w2,
                       dtype=torch.bool, device=x.device)


def cross_norm_2ins(x: torch.Tensor, *, crop: str = "neither",
                    beta: float = 1.0, bbx_thres: float = 0.1,
                    lam: Optional[float] = None, chan: bool = False,
                    num_groups: int = 1, eps: float = 1e-5,
                    generator: Optional[torch.Generator] = None,
                    **draws) -> torch.Tensor:
    """2-instance CrossNorm on an NHWC batch
    (``cnsn_tpu/ops/crossnorm.py:66-125``), in x's type:
    x_aug = (x − μ_c)/σ_c · σ_s[perm] + μ_s[perm], kept inside the content
    box only for crop 'content'/'both', then mixed with x by ``lam``.
    ``draws``: any of perm, style_box, content_box, chan_perm, and
    ``rows`` (``draw``)."""
    d = draw(x, crop, beta=beta, bbx_thres=bbx_thres, chan=chan,
             num_groups=num_groups, generator=generator, **draws)
    (s_mean, s_std), (c_mean, c_std) = pair_stats(x, crop, d, eps)
    x_aug = (x - c_mean) / c_std * s_std + s_mean
    if d["content_box"] is not None:
        x_aug = torch.where(_content_mask(x, d), x_aug, x)
    if lam is not None:
        x_aug = x * lam + x_aug * (1.0 - lam)
    return x_aug.to(x.dtype)


def cross_norm_fma(x: torch.Tensor, active: bool, *, crop: str = "neither",
                   beta: float = 1.0, bbx_thres: float = 0.1,
                   lam: Optional[float] = None, chan: bool = False,
                   num_groups: int = 1, eps: float = 1e-5,
                   generator: Optional[torch.Generator] = None,
                   **draws) -> torch.Tensor:
    """Branchless CrossNorm (``cnsn_tpu/ops/crossnorm.py:128-194``), the
    same transfer as :func:`cross_norm_2ins` as one fp32 FMA per element:
    out = x·scale + shift with scale = σ_s/σ_c and shift = μ_s − μ_c·scale
    per (N, C), the statistics in x's type and the FMA in fp32, composited
    with x outside the content box, cast back to x's type.

    ``active`` is the site's host gate.  JAX folds an idle gate into
    scale 1 and shift 0, which gives x back exactly, with the identity as
    its gradient; here an idle call returns x and draws and launches
    nothing."""
    if not active:
        return x
    d = draw(x, crop, beta=beta, bbx_thres=bbx_thres, chan=chan,
             num_groups=num_groups, generator=generator, **draws)
    (s_mean, s_std), (c_mean, c_std) = pair_stats(x, crop, d, eps)
    ct = torch.promote_types(x.dtype, torch.float32)
    scale = (s_std / c_std).to(ct)
    shift = (s_mean - c_mean * scale).to(ct)
    if lam is not None:
        scale = lam + (1.0 - lam) * scale
        shift = (1.0 - lam) * shift
    xf = x.to(ct)
    out = xf * scale + shift
    if d["content_box"] is not None:
        out = torch.where(_content_mask(x, d), out, xf)
    return out.to(x.dtype)
