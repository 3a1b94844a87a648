"""Tensor ops of the port.  Importing this package registers the custom
op ``torch.ops.cnsn_tpu_torch.selfnorm_infer`` that exported artifacts
call."""
from .bbox import sample_bbox
from .convdot import conv2d_custom_bwd
from .crossnorm import (cross_norm_2ins, cross_norm_fma, grouped_permutation,
                        instance_norm_mix)
from .kernels import (BnSums, InsStats, bn_sums_bwd_cuda,
                      bn_sums_bwd_reference, bn_sums_cuda, bn_sums_reference,
                      ins_stats_bwd_cuda, ins_stats_bwd_reference,
                      ins_stats_cuda, ins_stats_reference, wgrad3x3_cuda,
                      wgrad3x3_path, wgrad3x3_reference)
from .kernels.selfnorm import (selfnorm_infer, selfnorm_infer_cuda,
                               selfnorm_infer_reference, selfnorm_path)
from .stats import instance_mean_std, masked_instance_mean_std, region_mask

__all__ = ["BnSums", "InsStats", "bn_sums_bwd_cuda", "bn_sums_bwd_reference",
           "bn_sums_cuda", "bn_sums_reference", "conv2d_custom_bwd",
           "cross_norm_2ins", "cross_norm_fma", "grouped_permutation",
           "ins_stats_bwd_cuda", "ins_stats_bwd_reference", "ins_stats_cuda",
           "ins_stats_reference", "instance_mean_std", "instance_norm_mix",
           "masked_instance_mean_std", "region_mask", "sample_bbox",
           "selfnorm_infer",
           "selfnorm_infer_cuda", "selfnorm_infer_reference",
           "selfnorm_path", "wgrad3x3_cuda", "wgrad3x3_path", "wgrad3x3_reference"]
