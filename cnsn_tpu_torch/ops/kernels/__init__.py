"""Hand-written Hopper kernels (CUDA C++ under ``cnsn_tpu_torch/csrc``),
each beside its plain PyTorch version.  ``_build`` compiles and loads
them at first use; ``LAUNCHES`` counts their launches, by wrapper name.

  K1  ``ins_stats``   instance mean/std and its backward  (``csrc/ins_stats.cu``)
  K2  ``bn_stats``    shifted BatchNorm sums and backward (``csrc/bn_stats.cu``)
  K3  ``selfnorm``    fused eval SelfNorm                 (``csrc/selfnorm.cu``)
  K4  ``conv_wgrad``  3×3 stride-1 conv weight gradient   (``csrc/conv_wgrad.cu``;
                      a wgmma and a wmma kernel, ``wgrad3x3_path`` between them)
"""
from ._build import LAUNCHES, build
from .bn_stats import (BnSums, bn_sums_bwd_cuda, bn_sums_bwd_reference,
                       bn_sums_cuda, bn_sums_reference)
from .conv_wgrad import wgrad3x3_cuda, wgrad3x3_path, wgrad3x3_reference
from .ins_stats import (InsStats, ins_stats_bwd_cuda, ins_stats_bwd_reference,
                        ins_stats_cuda, ins_stats_reference)

# the libraries the kernels above are built into, one per csrc/<name>.cu
LIBRARIES = ("ins_stats", "bn_stats", "selfnorm", "conv_wgrad")

__all__ = ["LAUNCHES", "LIBRARIES", "BnSums", "InsStats", "build",
           "bn_sums_bwd_cuda", "bn_sums_bwd_reference", "bn_sums_cuda",
           "bn_sums_reference", "ins_stats_bwd_cuda",
           "ins_stats_bwd_reference", "ins_stats_cuda",
           "ins_stats_reference", "wgrad3x3_cuda", "wgrad3x3_path",
           "wgrad3x3_reference"]
