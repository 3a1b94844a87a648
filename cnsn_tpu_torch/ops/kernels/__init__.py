"""Hand-written Hopper kernels (CUDA C++ under ``cnsn_tpu_torch/csrc``),
each beside its plain PyTorch version.  ``_build`` compiles and loads
them at first use; ``LAUNCHES`` counts their launches."""
from ._build import LAUNCHES, build

__all__ = ["LAUNCHES", "build"]
