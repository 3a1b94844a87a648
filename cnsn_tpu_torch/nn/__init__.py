"""Layers of the port (train and eval mode)."""
from .cnsn import CNSN, CrossNorm, SelfNorm
from .norm import IBN, BatchNorm, BatchNorm1dStats, InstanceNorm, gelu_sig

__all__ = ["BatchNorm", "BatchNorm1dStats", "CNSN", "CrossNorm", "IBN",
           "InstanceNorm", "SelfNorm", "gelu_sig"]
