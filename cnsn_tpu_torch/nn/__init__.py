"""Layers of the port (eval mode)."""
from .cnsn import CNSN, CrossNorm, SelfNorm
from .norm import BatchNorm, BatchNorm1dStats

__all__ = ["BatchNorm", "BatchNorm1dStats", "CNSN", "CrossNorm", "SelfNorm"]
