"""Layers of the port (train and eval mode)."""
from .cnsn import CNSN, CrossNorm, SelfNorm
from .norm import BatchNorm, BatchNorm1dStats

__all__ = ["BatchNorm", "BatchNorm1dStats", "CNSN", "CrossNorm", "SelfNorm"]
