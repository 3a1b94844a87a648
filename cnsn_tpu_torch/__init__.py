"""cnsn_tpu_torch: the PyTorch/CUDA port of cnsn_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout module for module and imports
nothing of it (nor JAX).  It serves the ResNet-50 + SelfNorm eval forward
and trains every classification recipe end to end through ``cli
train``: ResNet-50 and ResNet-50-IBN-b on ImageNet image folders, and the
four CIFAR models, WRN-40-2, AllConvNet, DenseNet-40-12 and ResNeXt-29,
host AugMix included, and the GTAV→Cityscapes FCN-ResNet50 ± CNSN
segmenter through ``cli seg-train``/``seg-eval``, on the hand-written
Hopper kernels of ``ops/kernels`` (``csrc/*.cu``), on one card or on N
data-parallel ranks (``parallel/``, ``num_devices=N``).
"""
from .models import build_classifier, build_model

__all__ = ["build_classifier", "build_model"]
