"""PSPNet, PSANet and PSALite heads on the dilated CNSN backbone: port of
``cnsn_tpu/segmentation/pspnet.py`` (reference segmentation/model/
pspnet.py:8-107 PPM + PSPNet; segmentation/model/psanet.py PSA/PSANet).

  * ``PPM``: adaptive average pooling at bins (1, 2, 3, 6), each bin a
    1×1 conv (2048 → 512, no bias), BatchNorm and ReLU, upsampled back
    with ``align_corners=True`` and concatenated to the input (4096);
  * ``ClsHead`` (``fcn.py``): 3×3 conv → BN → ReLU → Dropout(0.1) →
    1×1 conv with bias, 512 wide for ``cls``, 256 for ``aux`` (layer3);
  * ``PSA``: the collect / distribute branches (``psa_type`` 0 / 1 / 2)
    on a map shrunk by ``shrink_factor``; the over-complete attention map
    (``mask_h``·``mask_w`` channels a position) becomes the (h·w, h·w)
    attention by one static gather (``psa_mask_indices``) of the
    zero-padded map, ``compact`` by a reshape; softmax over the global
    axis in float32, then the aggregation as a batched matrix product
    (plain torch: the JAX package computes it outside any Pallas kernel);
  * ``PSALite``: attention of each position over a 15×15 pooled grid.

The backbone is ``seg_resnet50`` of this module in 'psp' dilation mode
(replace it to cut the depth, as in the JAX package); BatchNorm trains
through K2, SelfNorm through K1 (train) and K3 (eval), as in the FCN.
The heads upsample with ``align_corners=True`` (``UPSAMPLE_ALIGN_CORNERS``
tells ``SegStepFns`` which fused matrices to use) and return float32 (or
float64) logits, NHWC, at (H − 1) // 8 · zoom_factor + 1, or at stride 8
with ``upsample=False``.  Module names follow the reference torch state
dict (``ppm.features.0.1``, ``cls.4``, ``psa.attention.3``); the JAX names
map onto them through ``utils/jax_params.py``'s ``SEG_KEY_MAP``.

PSANet and PSALite take the image size at construction: the number of
output channels of PSA's attention conv (one per mask cell, or per
position when compact) and of PSALite's (one per grid cell) follows from
it, where flax shapes them at the first call.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import Conv2d
from ..nn.norm import BatchNorm
from .backbone import seg_resnet50
from .fcn import ClsHead, _lecun_normal, _ReLU

__all__ = ["PPM", "PSPNet", "PSA", "PSANet", "PSALite", "psa_mask_indices"]


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """The layout K2 reads (a no-op where x has it already)."""
    return x.contiguous(memory_format=torch.channels_last)


def _resize_align_corners(x: torch.Tensor, hw: Tuple[int, int]
                          ) -> torch.Tensor:
    """Bilinear with ``align_corners=True`` over an NCHW tensor, in
    channels_last memory (JAX ``pspnet.py:30-47``: the same 2-tap
    interpolation at linspace(0, h − 1, H); where a source row falls on an
    integer the two floors may differ, which moves the value by rounding
    alone)."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return _channels_last(F.interpolate(x, size=tuple(hw), mode="bilinear",
                                        align_corners=True))


def _feature_size(image_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(h, w) of the backbone's stride-8 features for an (H, W) image: the
    stem conv, the max-pool and layer2 each halve (x − 1) // 2 + 1."""
    return tuple((s - 1) // 8 + 1 for s in image_hw)


def _out_size(x: torch.Tensor, zoom_factor: int) -> Tuple[int, int]:
    return tuple((s - 1) // 8 * zoom_factor + 1 for s in x.shape[1:3])


def _conv1x1(in_ch: int, out_ch: int, dtype, g) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1, dtype=dtype, generator=g)


def _to_float(z: torch.Tensor) -> torch.Tensor:
    return z.to(torch.promote_types(z.dtype, torch.float32))


class PPM(nn.Module):
    """Pyramid Pooling Module (reference pspnet.py:8-26): NCHW in, the
    input and its ``len(bins)`` pooled branches concatenated out."""

    def __init__(self, in_dim: int, reduction_dim: int,
                 bins: Sequence[int] = (1, 2, 3, 6),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator()
        self.features = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b),
                          _conv1x1(in_dim, reduction_dim, dtype, g),
                          BatchNorm(reduction_dim), _ReLU())
            for b in bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[2:])
        outs = [x]
        for pool, conv, bn, relu in self.features:
            z = relu(bn(_channels_last(conv(pool(x)))))
            outs.append(_resize_align_corners(z, hw))
        return torch.cat(outs, dim=1)


class _SegHeads(nn.Module):
    """The CNSN 'psp' backbone and the ``cls``/``aux`` heads shared by
    PSPNet, PSANet and PSALite; a subclass builds ``context`` (layer4
    features → ``cls``'s input, NCHW)."""

    UPSAMPLE_ALIGN_CORNERS = True

    def __init__(self, cls_in: int, classes: int, dropout: float,
                 zoom_factor: int, block_idxs: str, pos, cn_pos, cnsn_type,
                 crop: str, beta: float, dtype, remat,
                 g: torch.Generator):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.backbone = seg_resnet50(
            block_idxs=block_idxs, pos=pos, cn_pos=cn_pos,
            cnsn_type=cnsn_type, crop=crop, beta=beta, dtype=dtype,
            remat=remat, dilation_mode="psp", generator=g)
        self.cls = ClsHead(cls_in, 512, classes, dropout, dtype, g)
        self.aux = ClsHead(1024, 256, classes, dropout, dtype, g)

    @property
    def cn_num(self) -> int:
        return self.backbone.cn_num

    @property
    def has_img_cn(self) -> bool:
        return self.backbone.has_img_cn

    def context(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, images: torch.Tensor,
                cn_active: Optional[Sequence[bool]] = None,
                img_cn_active: Optional[bool] = None,
                upsample: bool = True,
                cn_draws: Optional[Sequence[dict]] = None,
                img_cn_draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """NHWC images → (out, aux) logits, NHWC, at (H − 1) // 8 ·
        zoom_factor + 1 (``upsample=False``: at stride 8, for the
        class-major fused upsample + cross-entropy)."""
        feats = self.backbone(images, cn_active, img_cn_active, cn_draws,
                              img_cn_draws, generator)
        out = self.cls(self.context(feats["out"].permute(0, 3, 1, 2)))
        aux = self.aux(feats["aux"].permute(0, 3, 1, 2))
        out, aux = _to_float(out), _to_float(aux)
        if upsample and self.zoom_factor != 1:
            hw = _out_size(images, self.zoom_factor)
            out = _resize_align_corners(out, hw)
            aux = _resize_align_corners(aux, hw)
        return out.permute(0, 2, 3, 1), aux.permute(0, 2, 3, 1)


class PSPNet(_SegHeads):
    """PSPNet on the CNSN backbone (reference pspnet.py:29-107): PPM on
    layer4, the 512-wide ``cls`` head on its 4096 channels, ``aux`` on
    layer3.  ``generator`` seeds every initializer."""

    def __init__(self, classes: int = 19, bins: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1, zoom_factor: int = 8,
                 use_ppm: bool = True, block_idxs: str = "",
                 pos: Optional[str] = None, cn_pos: Optional[str] = None,
                 cnsn_type: Optional[str] = None, crop: str = "neither",
                 beta: float = 1.0, dtype: Optional[torch.dtype] = None,
                 remat: Any = False,
                 generator: Optional[torch.Generator] = None):
        g = generator or torch.Generator()
        fea_dim = 2048
        super().__init__(fea_dim * 2 if use_ppm else fea_dim, classes,
                         dropout, zoom_factor, block_idxs, pos, cn_pos,
                         cnsn_type, crop, beta, dtype, remat, g)
        self.ppm = (PPM(fea_dim, fea_dim // len(bins), bins, dtype, g)
                    if use_ppm else None)

    def context(self, z: torch.Tensor) -> torch.Tensor:
        return z if self.ppm is None else self.ppm(z)


def psa_mask_indices(h: int, w: int, mask_h: int, mask_w: int) -> np.ndarray:
    """Static index map of the reference's psa_mask CUDA op
    (segmentation/lib/psa, called at psanet.py:67,85-86), JAX
    ``pspnet.py:160-181``: idx (h·w, h·w), idx[g, p] the channel of the
    over-complete (mask_h·mask_w)-deep map at position p that lands on
    global position g, or the sentinel mask_h·mask_w (a zero channel,
    which takes part in the softmax as torch's zero-filled buffer) where g
    lies outside p's window."""
    half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
    a, i = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    dh = a - i + half_h                       # (h_global, h_pos)
    b, j = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    dw = b - j + half_w                       # (w_global, w_pos)
    ok = ((dh >= 0) & (dh < mask_h))[:, None, :, None] \
        & ((dw >= 0) & (dw < mask_w))[None, :, None, :]
    idx = dh[:, None, :, None] * mask_w + dw[None, :, None, :]
    idx = np.where(ok, idx, mask_h * mask_w)
    return idx.reshape(h * w, h * w).astype(np.int32)


class PSA(nn.Module):
    """Point-wise Spatial Attention (reference psanet.py:9-98; JAX
    ``pspnet.py:184-288``) on an NCHW map of ``feature_hw``: the input
    and the projected attention output concatenated (2·in_channels).

    psa_type 0 collect, 1 distribute, 2 both (``reduce_p``/
    ``attention_p`` the distribute branch's).  mask_h/mask_w 0: 2h − 1 of
    the shrunk map h = (fh − 1) // shrink_factor + 1, which must divide
    evenly (the reference's F.interpolate round trip)."""

    def __init__(self, in_channels: int = 2048, mid_channels: int = 512,
                 feature_hw: Tuple[int, int] = (89, 89), psa_type: int = 2,
                 compact: bool = False, shrink_factor: int = 2,
                 mask_h: int = 0, mask_w: int = 0,
                 normalization_factor: float = 1.0, psa_softmax: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if psa_type not in (0, 1, 2):
            raise ValueError(f"psa_type {psa_type}: 0, 1 or 2")
        g = generator or torch.Generator()
        fh, fw = feature_hw
        sf = shrink_factor
        if (fh - 1) % sf or (fw - 1) % sf:
            raise ValueError(
                f"feature size {fh}x{fw}: (size - 1) % shrink_factor ({sf}) "
                "must be 0 (the reference's F.interpolate round trip)")
        self.feature_hw = (fh, fw)
        self.hw = ((fh - 1) // sf + 1, (fw - 1) // sf + 1)
        h, w = self.hw
        self.mask = (mask_h or 2 * h - 1, mask_w or 2 * w - 1)
        self.psa_type, self.compact = psa_type, compact
        self.normalization_factor = normalization_factor
        self.psa_softmax = psa_softmax
        mask_hw = h * w if compact else self.mask[0] * self.mask[1]

        def reduce():
            return nn.Sequential(_conv1x1(in_channels, mid_channels, dtype, g),
                                 BatchNorm(mid_channels), _ReLU())

        def attention():
            return nn.Sequential(_conv1x1(mid_channels, mid_channels, dtype,
                                          g),
                                 BatchNorm(mid_channels), _ReLU(),
                                 _conv1x1(mid_channels, mask_hw, dtype, g))

        self.reduce, self.attention = reduce(), attention()
        self.reduce_p = self.attention_p = None
        if psa_type == 2:
            self.reduce_p, self.attention_p = reduce(), attention()
        # the gather's index (not in the state dict: a function of sizes)
        self.register_buffer(
            "mask_index", None if compact else torch.from_numpy(
                psa_mask_indices(h, w, *self.mask)).long(),
            persistent=False)
        branches = 2 if psa_type == 2 else 1
        self.proj = nn.Sequential(
            _conv1x1(mid_channels * branches, in_channels, dtype, g),
            BatchNorm(in_channels), _ReLU())

    def _expand(self, y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(n, M, h, w) over-complete map → (n, h·w, h·w) attention in
        collect orientation (global axis first)."""
        n, m = y.shape[:2]
        p = y.shape[2] * y.shape[3]
        yp = torch.cat([y.reshape(n, m, p),
                        y.new_zeros(n, 1, p)], dim=1)      # (n, M+1, P)
        return torch.gather(yp, 1, idx.expand(n, -1, -1))  # (n, G, P)

    def _branch(self, feat: torch.Tensor, attn_raw: torch.Tensor,
                distribute: bool) -> torch.Tensor:
        n, c, h, w = feat.shape
        if self.compact:
            # (n, G, P): the conv's h·w channels are the global positions
            a = attn_raw.reshape(n, h * w, h * w)
        else:
            a = self._expand(attn_raw, self.mask_index)
        if distribute:
            a = a.transpose(1, 2)
        dt = torch.promote_types(feat.dtype, torch.float32)
        a = a.to(dt)
        if self.psa_softmax:
            a = torch.softmax(a, dim=1)
        f = feat.permute(0, 2, 3, 1).reshape(n, h * w, c).to(dt)
        out = torch.bmm(a.transpose(1, 2), f) / self.normalization_factor
        return out.to(feat.dtype).reshape(n, h, w, c).permute(0, 3, 1, 2)

    def _side(self, x, reduce, attention, distribute):
        z = _resize_align_corners(reduce(x), self.hw)
        return self._branch(z, attention(z), distribute)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != self.feature_hw:
            raise ValueError(f"PSA built for {self.feature_hw} features, "
                             f"got {tuple(x.shape[2:])}")
        if self.psa_type == 2:
            z = torch.cat(
                [self._side(x, self.reduce, self.attention, False),
                 self._side(x, self.reduce_p, self.attention_p, True)],
                dim=1)
        else:
            z = self._side(x, self.reduce, self.attention,
                           self.psa_type == 1)
        z = self.proj(_channels_last(z))
        z = _resize_align_corners(z, self.feature_hw)
        return torch.cat([x, z], dim=1)


class PSANet(_SegHeads):
    """PSANet on the CNSN backbone (reference psanet.py:101-179; a dead
    path there, functional here as in the JAX package): PSA on layer4,
    the ``cls`` head on its 4096 channels, ``aux`` on layer3.
    ``image_hw``: the (H, W) of the images it takes."""

    def __init__(self, classes: int = 19,
                 image_hw: Tuple[int, int] = (705, 705), psa_type: int = 2,
                 compact: bool = False, shrink_factor: int = 2,
                 mask_h: int = 0, mask_w: int = 0,
                 normalization_factor: float = 1.0, psa_softmax: bool = True,
                 dropout: float = 0.1, zoom_factor: int = 8,
                 block_idxs: str = "", pos: Optional[str] = None,
                 cn_pos: Optional[str] = None,
                 cnsn_type: Optional[str] = None, crop: str = "neither",
                 beta: float = 1.0, dtype: Optional[torch.dtype] = None,
                 remat: Any = False,
                 generator: Optional[torch.Generator] = None):
        g = generator or torch.Generator()
        super().__init__(4096, classes, dropout, zoom_factor, block_idxs,
                         pos, cn_pos, cnsn_type, crop, beta, dtype, remat, g)
        self.psa = PSA(2048, 512, _feature_size(image_hw), psa_type, compact,
                       shrink_factor, mask_h, mask_w, normalization_factor,
                       psa_softmax, dtype, g)

    def context(self, z: torch.Tensor) -> torch.Tensor:
        return self.psa(z)


class PSALite(_SegHeads):
    """Compact PSA variant (JAX ``pspnet.py:360-430``; not in the
    reference): each position attends over a ``pool_hw``² pooled grid of
    the reduced features (a softmax over its cells), and the aggregate is
    concatenated to layer4 (2048 + psa_dim channels) for ``cls``.
    ``image_hw``: the (H, W) of the images it takes."""

    def __init__(self, classes: int = 19,
                 image_hw: Tuple[int, int] = (713, 713), psa_dim: int = 512,
                 pool_hw: int = 15, dropout: float = 0.1,
                 zoom_factor: int = 8, block_idxs: str = "",
                 pos: Optional[str] = None, cn_pos: Optional[str] = None,
                 cnsn_type: Optional[str] = None, crop: str = "neither",
                 beta: float = 1.0, dtype: Optional[torch.dtype] = None,
                 remat: Any = False,
                 generator: Optional[torch.Generator] = None):
        g = generator or torch.Generator()
        super().__init__(2048 + psa_dim, classes, dropout, zoom_factor,
                         block_idxs, pos, cn_pos, cnsn_type, crop, beta,
                         dtype, remat, g)
        self.feature_hw = _feature_size(image_hw)
        self.grid = min(pool_hw, self.feature_hw[0])
        self.psa_reduce = _conv1x1(2048, psa_dim, dtype, g)
        self.psa_bn = BatchNorm(psa_dim)
        self.psa_relu = _ReLU()
        cells = self.grid * self.grid
        self.psa_attn = Conv2d(psa_dim, cells, 1, dtype=dtype, generator=g,
                               bias=True)
        with torch.no_grad():
            self.psa_attn.weight.copy_(_lecun_normal((cells, psa_dim, 1, 1),
                                                     g))

    def context(self, z: torch.Tensor) -> torch.Tensor:
        if tuple(z.shape[2:]) != self.feature_hw:
            raise ValueError(f"PSALite built for {self.feature_hw} "
                             f"features, got {tuple(z.shape[2:])}")
        n, _, fh, fw = z.shape
        v = self.psa_relu(self.psa_bn(self.psa_reduce(z)))
        grid = F.adaptive_avg_pool2d(v, self.grid)
        attn = self.psa_attn(v)
        cells = grid.shape[2] * grid.shape[3]
        attn = torch.softmax(attn.permute(0, 2, 3, 1).reshape(
            n, fh * fw, cells), dim=-1)
        dt = torch.promote_types(attn.dtype, torch.float32)
        g = grid.permute(0, 2, 3, 1).reshape(n, cells, -1).to(dt)
        agg = torch.bmm(attn.to(dt), g).to(z.dtype)
        agg = agg.reshape(n, fh, fw, -1).permute(0, 3, 1, 2)
        return torch.cat([z, agg], dim=1)
