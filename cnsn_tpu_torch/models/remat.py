"""Rematerialised blocks: the counterpart of the JAX package's
``nn.remat(Block, static_argnums=(2,))`` (``cnsn_tpu/models/resnet.py:
143``, ``resnet_ibn.py:142``, ``segmentation/backbone.py:190``).

A block called through :func:`block_call` of a model with ``remat`` on
keeps only its inputs in the forward pass and runs its forward again in
the backward pass to rebuild its activations: memory for FLOPs.  It is
non-reentrant ``torch.utils.checkpoint.checkpoint``, under a ``Replay``
(``ops/recompute.py``) that hands the recomputation the first run's
BatchNorm shifts and CrossNorm draws and keeps it from updating the
running statistics a second time, so a step with remat equals the step
without.  It applies only in training with grad enabled; in eval, without
grad and under ``torch.export`` the block runs as it is.  The global
random generators are not saved: the blocks draw only from the explicit
generators that the replay covers.
"""
from __future__ import annotations

from typing import Any, Set

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.recompute import Replay, scope

__all__ = ["block_call", "remat_active", "remat_stages"]


def remat_active(module: nn.Module) -> bool:
    """Whether a call of ``module`` now would be rematerialised: in
    training, with grad enabled, and not while exporting or compiling."""
    return (module.training and torch.is_grad_enabled()
            and not torch.compiler.is_exporting()
            and not torch.compiler.is_compiling())


def block_call(block: nn.Module, remat: bool, *args: Any) -> Any:
    """``block(*args)``, rematerialised when ``remat`` is set and
    :func:`remat_active` holds."""
    if not (remat and remat_active(block)):
        return block(*args)
    replay = Replay()

    def run(*inputs):
        with scope(replay):
            return block(*inputs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def remat_stages(remat: Any) -> Set[int]:
    """The stages (1–4) whose bottlenecks a segmentation backbone
    rematerialises, from its ``remat`` knob, as JAX's
    ``SegResNet.remat_stages`` (``cnsn_tpu/segmentation/backbone.py:
    147-156``): True every stage, False none; a stage spec string '1_2';
    an int, the digit set of what an unquoted YAML ``remat: 1_2`` parses
    to (12), or ``34``."""
    if isinstance(remat, int) and not isinstance(remat, bool):
        return {int(c) for c in str(remat)}
    if isinstance(remat, str):
        return {int(v) for v in remat.split("_") if v}
    return {1, 2, 3, 4} if remat else set()
