"""Segmentation (GTAV → Cityscapes domain generalisation): port of
``cnsn_tpu/segmentation``: the dilated CNSN backbone, the FCN, PSPNet,
PSANet and PSALite heads, the steps, the transforms and loaders, the
``SegTrainer`` and ``vis.py``."""
from .backbone import SegResNet, seg_resnet50
from .fcn import FCNCNSN, FCNHead, fcn_baseline, fcn_cnsn
from .pspnet import PPM, PSA, PSALite, PSANet, PSPNet
from .train_seg import (SegStepFns, SegTrainState, make_seg_optimizer,
                        masked_cross_entropy, masked_nll_sum, seg_metrics)

__all__ = [
    "SegResNet", "seg_resnet50", "FCNCNSN", "FCNHead", "fcn_baseline",
    "fcn_cnsn", "PPM", "PSA", "PSALite", "PSANet", "PSPNet",
    "SegStepFns", "SegTrainState", "make_seg_optimizer",
    "masked_cross_entropy", "masked_nll_sum", "seg_metrics",
]
