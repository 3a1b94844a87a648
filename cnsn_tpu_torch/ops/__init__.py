"""Tensor ops of the port.  Importing this package registers the custom
op ``torch.ops.cnsn_tpu_torch.selfnorm_infer`` that exported artifacts
call."""
from .kernels.selfnorm import (selfnorm_infer, selfnorm_infer_cuda,
                               selfnorm_infer_reference)
from .stats import instance_mean_std

__all__ = ["instance_mean_std", "selfnorm_infer", "selfnorm_infer_cuda",
           "selfnorm_infer_reference"]
