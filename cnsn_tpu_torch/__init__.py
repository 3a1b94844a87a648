"""cnsn_tpu_torch: the PyTorch/CUDA port of cnsn_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout module for module and imports
nothing of it (nor JAX).  This slice serves the ResNet-50 + SelfNorm eval
forward; its one kernel is the hand-written fused eval SelfNorm
(``ops/kernels/selfnorm.py``, ``csrc/selfnorm.cu``).
"""
from .models import build_classifier, build_model

__all__ = ["build_classifier", "build_model"]
