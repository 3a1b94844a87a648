"""Segmentation (GTAV → Cityscapes domain generalisation): port of
``cnsn_tpu/segmentation``'s FCN path.  The PSP/PSA heads (``pspnet.py``)
and ``vis.py`` are not ported yet (ROADMAP queue 1)."""
from .backbone import SegResNet, seg_resnet50
from .fcn import FCNCNSN, FCNHead, fcn_baseline, fcn_cnsn
from .train_seg import (SegStepFns, SegTrainState, make_seg_optimizer,
                        masked_cross_entropy, masked_nll_sum, seg_metrics)

__all__ = [
    "SegResNet", "seg_resnet50", "FCNCNSN", "FCNHead", "fcn_baseline",
    "fcn_cnsn", "SegStepFns", "SegTrainState", "make_seg_optimizer",
    "masked_cross_entropy", "masked_nll_sum", "seg_metrics",
]
