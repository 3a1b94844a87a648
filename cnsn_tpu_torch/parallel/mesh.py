"""Data parallelism over the ranks of a process group: port of
``cnsn_tpu/parallel/mesh.py`` (reference: DataParallel at cifar.py:395,
imagenet.py:533; DDP + NCCL at segmentation/tool/train_cnsn.py:95-122).

JAX jits one step over a mesh and GSPMD emits the gradient psum; here
every rank runs the step on its rows and ``DataParallel.all_reduce_grads``
averages the gradients after ``backward()`` and before SGD, one flat
all-reduce a type, with no hooks.  A step that runs several forwards in
one graph (the consistency and AugMix-CrossNorm regimes) or recomputes
blocks (remat) needs nothing more.  BatchNorm's sums are all-reduced
inside the forward (``nn/norm.py``), and the CrossNorm pairing stays
within a rank (``ops/crossnorm.py``: the global ``grouped_permutation``
with one group a rank), as the reference's per-GPU ``torch.randperm``;
AugMix's image CrossNorm pairs within blocks of the flattened views, as
JAX does, and gathers the partners' statistics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

__all__ = ["DataParallel", "Mesh", "average_gradients", "make_mesh"]


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``size`` ranks, this process being ``rank``."""
    size: int
    rank: int


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The mesh of this process's world: every rank of the group (which
    ``num_devices``, if given, must equal), or one rank without a group."""
    w = distributed.world()
    size = w.size if w is not None else 1
    if num_devices is not None and num_devices != size:
        raise ValueError(
            f"num_devices={num_devices} but this process is one of {size} "
            "rank(s): launch through cli train/seg-train num_devices=N, "
            "torchrun, or parallel.launch.spawn")
    return Mesh(size, w.rank if w is not None else 0)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the gradients of ``params`` over the ranks in place: one
    flat all-reduce for the gradients of each (type, device), divided by
    the rank count.  Every parameter must have a gradient.  Nothing
    without a process group; at one rank of a group the all-reduce runs
    and changes no bit."""
    w = distributed.world()
    if w is None:
        return
    buckets: dict = {}
    for p in params:
        buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        distributed.all_reduce_(flat, "grads")
        flat /= w.size
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


class DataParallel:
    """The data-parallel helpers of a mesh: replicate the state from rank
    0, take a rank's rows of a batch, average or add metrics over the
    ranks (the gradients: ``average_gradients``, which the steps call)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the logs and checkpoints."""
        return self.mesh.rank == 0

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Broadcast ``module``'s parameters and buffers from rank 0, in
        place (one broadcast a tensor; nothing on one rank)."""
        if distributed.world() is not None:
            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    distributed.COLLECTIVES["broadcast"] += 1
                    dist.broadcast(t.data, src=0)
        return module

    def shard_batch(self, array, axis: int = 0):
        """This rank's rows of ``array`` (numpy or torch) along ``axis``
        (0 for (B, ...) batches, 1 for the (3, B, ...) stacked AugMix
        views); raises where the batch does not divide."""
        n = array.shape[axis]
        if n % self.mesh.size != 0:
            raise ValueError(f"batch of {n} not divisible by "
                             f"{self.mesh.size} ranks")
        per = n // self.mesh.size
        if self.mesh.size == 1:
            return array
        start = self.mesh.rank * per
        if isinstance(array, torch.Tensor):
            return array.narrow(axis, start, per)
        return np.take(array, np.arange(start, start + per), axis=axis)

    def shard_inputs(self, images, labels):
        axis = 1 if images.ndim == 5 else 0
        return self.shard_batch(images, axis), self.shard_batch(labels, 0)

    def mean(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """The means over the ranks of device scalars, stacked as one
        float64 tensor (one all-reduce)."""
        t = torch.stack([v.detach().double().reshape(()) for v in values])
        if distributed.world() is not None:
            distributed.all_reduce_(t, "metrics")
            t /= self.mesh.size
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (one all-reduce)."""
        if distributed.world() is not None:
            distributed.all_reduce_(t, "metrics")
        return t
