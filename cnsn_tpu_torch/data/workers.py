"""Host-augmentation worker processes: port of ``cnsn_tpu/data/workers.py``.

The reference overlaps its PIL AugMix cost with the training step through
DataLoader worker processes (cifar.py:361-366, imagenet.py:482-505).  A
thread pool cannot: the AugMix op chain is GIL-bound Python and PIL, so
threads serialize at about one core.  ``PrefetchPool`` is a persistent
process pool with one batch of look-ahead: batch k+1 is being augmented
in the workers while the step consumes batch k.

Every image's views are a pure function of (pixels or path, seed), and
the serial path and the pool call the same module-level function with
the same per-image seeds, so their batches are equal bit for bit.

The pool always starts with ``forkserver``.  A forked child of a process
that has initialised CUDA cannot use CUDA, and it copies the state of
every lock held by another thread at the fork; forkserver's children
descend from a clean single-threaded server process.  The pool is made
when the loader is built, so its start-up cost lands before the first
step, and it lives until ``close()``.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Callable, Iterable, Iterator, Tuple

__all__ = ["PrefetchPool"]


class PrefetchPool:
    """A persistent worker pool that maps a per-item function over
    batches, with one batch of work ahead."""

    def __init__(self, num_workers: int):
        if num_workers <= 0:
            raise ValueError("PrefetchPool needs num_workers > 0")
        self.num_workers = num_workers
        self._pool = mp.get_context("forkserver").Pool(num_workers)

    def run(self, fn: Callable, batches: Iterable[Tuple[list, object]]
            ) -> Iterator[Tuple[list, object]]:
        """``batches`` yields ``(items, meta)``; yields ``(results, meta)``
        in order, the next batch's work dispatched before the current one
        is handed out."""
        if self._pool is None:
            raise RuntimeError("PrefetchPool used after close()")
        prev = None
        for items, meta in batches:
            chunk = max(1, len(items) // (4 * self.num_workers))
            fut = self._pool.map_async(fn, items, chunksize=chunk)
            if prev is not None:
                yield prev[0].get(), prev[1]
            prev = (fut, meta)
        if prev is not None:
            yield prev[0].get(), prev[1]

    def close(self):
        """Stop the workers (idempotent)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
