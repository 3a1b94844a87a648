"""Layers of the port (train and eval mode)."""
from .cnsn import CNSN, CrossNorm, SelfNorm
from .norm import BatchNorm, BatchNorm1dStats, gelu_sig

__all__ = ["BatchNorm", "BatchNorm1dStats", "CNSN", "CrossNorm", "SelfNorm",
           "gelu_sig"]
