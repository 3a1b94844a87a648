"""Data parallelism across processes: port of the data-parallel part of
``cnsn_tpu/parallel/`` (``distributed.py``, ``mesh.py``), one process a
rank, and the launchers that start the ranks (``launch.py``).  FSDP,
tensor parallelism, the GPipe pipeline and spatial partitioning are not
ported (ROADMAP queue 1, items 4b-4d)."""
from .distributed import (global_batch_array, initialize,
                          process_batch_slice, shutdown, world)
from .launch import RankPool, spawn
from .mesh import DataParallel, Mesh, make_mesh

__all__ = ["DataParallel", "Mesh", "RankPool", "global_batch_array",
           "initialize", "make_mesh", "process_batch_slice", "shutdown",
           "spawn", "world"]
