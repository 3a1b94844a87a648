"""Process groups and per-process data slicing: port of
``cnsn_tpu/parallel/distributed.py``.

The JAX package runs one program over the devices of a mesh and GSPMD
inserts the collectives; here each rank is a process of its own (the
reference's ``mp.spawn`` + NCCL, segmentation/tool/train_cnsn.py:95-122)
and the collectives are explicit: the BatchNorm sums (``nn/norm.py``),
the gradient bucket (``mesh.py``) and the metrics.

``initialize`` joins a process group and records the ``World`` this
process is a rank of; ``world()`` is None in a single-process run, and
every collective below is then the identity.  The backend is decided
before the group starts, never by retrying after a failure:

  * ``nccl`` where each rank has a card of its own;
  * ``gloo`` where ranks share a card (NCCL refuses two ranks on one
    device; gloo's collectives take CUDA tensors through the host), and
    on the CPU.

The collectives that sit on a training graph are autograd Functions:
``all_reduce_sum``'s backward is a sum all-reduce of the cotangents (each
rank's cotangent of a global sum reflects its own loss only, as torch's
SyncBatchNorm all-reduces ``sum_dy``), and ``all_gather_rows``'s backward
sums the cotangent of the gathered tensor over the ranks and keeps the
rank's own rows.  ``COLLECTIVES`` counts the calls by kind.
"""
from __future__ import annotations

import collections
import datetime
import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "COLLECTIVE_SECONDS", "World", "all_gather_rows",
           "all_reduce_", "all_reduce_sum", "any_rank", "barrier",
           "broadcast_object", "choose_backend", "global_batch_array",
           "global_rows", "initialize", "local_rows", "process_batch_slice",
           "shard_range", "shutdown", "world"]

# seconds a collective may wait for a rank before the group raises
DEFAULT_TIMEOUT = 300.0

# collective calls by kind (bn_sums and bn_stats forward, each with its
# _bwd; gather, gather_bwd; grads; loss_count; metrics; flag; broadcast)
COLLECTIVES: collections.Counter = collections.Counter()
# the host's wall seconds inside those calls, by kind (gloo returns when
# the collective is done; NCCL when it is queued on the card)
COLLECTIVE_SECONDS: collections.Counter = collections.Counter()


@dataclass(frozen=True)
class World:
    """This process's place in the process group: its rank of ``size``,
    its rank on this host, the device it computes on and the backend."""
    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


_WORLD: Optional[World] = None
# a gloo group over the same ranks for host flags: a CPU all-reduce that
# does not wait for the card (the default group where it is gloo)
_HOST_GROUP = None


def world() -> Optional[World]:
    """The ``World`` of ``initialize``, or None in a single-process run."""
    return _WORLD


def choose_backend(device_type: str, local_ranks: int,
                   cards: int) -> Tuple[str, str]:
    """(backend, reason) for ``local_ranks`` ranks on one host with
    ``cards`` cards: gloo on the CPU and where ranks share a card, nccl
    where each rank has one."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    if local_ranks <= cards:
        return "nccl", f"{local_ranks} ranks on {cards} cards, one each"
    return "gloo", (f"{local_ranks} ranks share {cards} card(s); NCCL "
                    "refuses two ranks on one device")


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, device: str = "cuda",
               timeout: float = DEFAULT_TIMEOUT) -> World:
    """Join a process group as ``rank`` of ``world_size`` and return the
    ``World``.  Without ``rank`` and ``world_size`` the environment of a
    ``torchrun`` launch gives them (RANK, WORLD_SIZE, and ``env://``).
    The rank computes on ``cuda:(local_rank % device_count)``, its rank
    on this host LOCAL_RANK of LOCAL_WORLD_SIZE where the environment
    has them (a torchrun launch) and else ``rank`` of ``world_size``, or
    on the CPU where ``device`` says so; CUDA asked for and absent
    raises.  The backend is ``choose_backend``'s, which rank 0 prints.
    The group waits at most ``timeout`` seconds in a collective, then
    raises."""
    global _WORLD, _HOST_GROUP
    if _WORLD is not None:
        raise RuntimeError("this process is already a rank of a group")
    env = os.environ
    if rank is None or world_size is None:
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = init_method or "env://"
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        cards, dev = 0, torch.device("cpu")
    backend, reason = choose_backend(dev_type, local_world_size, cards)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    _WORLD = World(rank, world_size, local_rank, dev, backend)
    _HOST_GROUP = (None if backend == "gloo"
                   else dist.new_group(backend="gloo"))
    if rank == 0:
        print(f"process group: {backend} ({reason}), {world_size} rank(s)",
              flush=True)
    return _WORLD


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    global _WORLD, _HOST_GROUP
    if _WORLD is not None:
        _WORLD = _HOST_GROUP = None
        dist.destroy_process_group()


def process_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's rows in the global batch — the
    DistributedSampler replacement; raises where the batch does not
    divide by the ranks."""
    w = _WORLD
    n, i = (w.size, w.rank) if w is not None else (1, 0)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"process count {n}")
    per = global_batch // n
    return i * per, per


def shard_range(n: int, rank: int, size: int) -> Tuple[int, int, int]:
    """(start, stop, rows) of ``rank``'s share of a batch of ``n`` rows
    padded to a multiple of ``size``: ``rows`` = ceil(n / size) rows a
    rank, of which [start, stop) are real and the rest padding."""
    rows = -(-n // size)
    start = min(rank * rows, n)
    return start, min(start + rows, n), rows


def global_rows(n_local: int) -> Tuple[int, int]:
    """(rows of the global batch, this rank's first row) for a rank that
    holds ``n_local`` rows; (n_local, 0) in a single-process run."""
    w = _WORLD
    if w is None:
        return n_local, 0
    return n_local * w.size, n_local * w.rank


def local_rows(t: Optional[torch.Tensor], n_local: int, axis: int = 0):
    """This rank's block of a draw made for the global batch (a dropout
    mask, a pairing): ``t`` as it is where its ``axis`` already has
    ``n_local`` rows."""
    n_global, start = global_rows(n_local)
    if t is None or t.shape[axis] == n_local:
        return t
    if t.shape[axis] != n_global:
        raise ValueError(f"a draw of {t.shape[axis]} rows for a batch of "
                         f"{n_global} ({n_local} on this rank)")
    return t.narrow(axis, start, n_local)


def global_batch_array(local: np.ndarray) -> torch.Tensor:
    """This rank's rows of the global batch on its device (the JAX
    package assembles a global array from them; here the rank computes
    on its rows and the collectives join the ranks)."""
    w = _WORLD
    dev = w.device if w is not None else torch.device("cpu")
    return torch.as_tensor(np.ascontiguousarray(local)).to(dev)


# ---- collectives ----------------------------------------------------------

def _all_reduce(t: torch.Tensor, kind: str) -> torch.Tensor:
    COLLECTIVES[kind] += 1
    t0 = time.perf_counter()
    dist.all_reduce(t)
    COLLECTIVE_SECONDS[kind] += time.perf_counter() - t0
    return t


def all_reduce_sum(*tensors: torch.Tensor, kind: str = "sums"):
    """The sums over the ranks of ``tensors``, all of one type and device
    (one flat all-reduce), with a sum all-reduce of the cotangents as the
    backward; the tensors as they are in a single-process run.  Returns
    a tuple.  Every rank must call it at the same point of its graph, and
    its results must reach every rank's loss: the backward is a
    collective too."""
    if _WORLD is None:
        return tensors
    return _SumFn.apply(kind, *tensors)


class _SumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, *tensors):
        ctx.kind = kind
        ctx.shapes = [t.shape for t in tensors]
        ctx.sizes = [t.numel() for t in tensors]
        ctx.like = (tensors[0].dtype, tensors[0].device)
        flat = _all_reduce(torch.cat([t.detach().reshape(-1)
                                      for t in tensors]), kind)
        return tuple(p.reshape(s)
                     for p, s in zip(flat.split(ctx.sizes), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        dtype, device = ctx.like
        flat = torch.cat([torch.zeros(n, dtype=dtype, device=device)
                          if g is None else g.reshape(-1)
                          for g, n in zip(grads, ctx.sizes)])
        flat = _all_reduce(flat, ctx.kind + "_bwd")
        return (None, *(p.reshape(s) for p, s in
                        zip(flat.split(ctx.sizes), ctx.shapes)))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        w = _WORLD
        ctx.rows, ctx.rank = t.shape[0], w.rank
        parts = [torch.empty_like(t) for _ in range(w.size)]
        COLLECTIVES["gather"] += 1
        t0 = time.perf_counter()
        dist.all_gather(parts, t.contiguous())
        COLLECTIVE_SECONDS["gather"] += time.perf_counter() - t0
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), "gather_bwd")
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated on axis 0 in rank order (each rank
    holds the same number of rows); its backward sums the cotangent over
    the ranks and keeps this rank's rows.  ``t`` in a single-process
    run."""
    if _WORLD is None:
        return t
    return _GatherRows.apply(t)


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no autograd); ``t`` in a
    single-process run."""
    if _WORLD is None:
        return t
    return _all_reduce(t, kind)


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank: a host all-reduce (max) that
    does not wait for the card; ``flag`` in a single-process run."""
    if _WORLD is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    COLLECTIVES["flag"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def broadcast_object(obj, src: int = 0):
    """``src``'s ``obj`` on every rank; ``obj`` in a single-process run."""
    if _WORLD is None:
        return obj
    box = [obj]
    COLLECTIVES["broadcast"] += 1
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    """Wait for every rank (nothing in a single-process run)."""
    if _WORLD is not None:
        dist.barrier()
