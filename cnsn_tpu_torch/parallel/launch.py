"""Starting the ranks: ``RankPool`` keeps N ranks alive, each a process
of one group, and runs the functions submitted to it on all of them (the
tests and ``chip_smoke.py`` run many cases in one group); ``spawn`` runs
one function on a pool of N ranks (the reference's ``mp.spawn``, which
``cli train num_devices=N`` calls).

The ranks start with the 'spawn' method and join the group through a
file under a directory of their own (no TCP port to clash).  A rank that
raises makes ``RankPool.run``, and so ``spawn``, raise with its
traceback once the others are stopped; a collective waiting on a dead
rank raises after the group's timeout, so nothing waits forever.
"""
from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.multiprocessing as mp

from . import distributed

__all__ = ["RankPool", "spawn"]


def _init_method(directory: str) -> str:
    return "file://" + os.path.join(os.path.abspath(directory), "store")


def spawn(fn: Callable, world_size: int, args: tuple = (),
          device: str = "cuda",
          timeout: float = distributed.DEFAULT_TIMEOUT) -> None:
    """Run ``fn(*args)`` on a ``RankPool`` of ``world_size`` ranks on
    ``device`` and wait for it, however long it takes (a collective waits
    at most ``timeout`` seconds); a rank that raises stops the others and
    makes this raise, and a rank that exits with a code of its own (143
    after a SIGTERM flush) makes this exit with it.  ``fn`` and ``args``
    must pickle."""
    with RankPool(world_size, device=device, timeout=timeout, threads=0,
                  wait=math.inf) as pool:
        try:
            pool.run(fn, *args)
        except RuntimeError:
            own = [c for c in pool.exitcodes if c is not None and c > 0]
            if own:
                raise SystemExit(own[0]) from None
            raise


def _serve(rank, world_size, init_method, device, timeout, threads, tasks,
           results):
    if threads:
        torch.set_num_threads(threads)
    try:
        distributed.initialize(rank, world_size, init_method, device=device,
                               timeout=timeout)
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # noqa: BLE001 — reported to the parent
                results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


class RankPool:
    """``world_size`` processes, each a rank of one group on ``device``,
    that run the functions ``run`` submits to all of them, in order.

    ``store_dir`` holds the group's rendezvous file (a fresh directory:
    the tests pass their ``tmp_path``); ``threads`` > 0 sets each rank's
    intra-op threads; ``timeout`` bounds a collective's wait in the group,
    and ``wait`` (None: ``timeout``) ``run``'s wait for a result.  CUDA
    asked for and absent raises.  The ranks may start processes of their
    own (the loaders' workers).  Use it as a context manager, or
    ``close()`` it: the ranks are stopped, and killed if they do not
    stop."""

    GRACE = 5.0

    def __init__(self, world_size: int, store_dir: Optional[str] = None,
                 device: str = "cpu", timeout: float = 120.0,
                 threads: int = 1, wait: Optional[float] = None):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "to run the ranks on the CPU")
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self.timeout = timeout
        self.wait = timeout if wait is None else wait
        self._own_dir = store_dir is None
        self.store_dir = store_dir or tempfile.mkdtemp(prefix="cnsn_ranks_")
        os.makedirs(self.store_dir, exist_ok=True)
        init = _init_method(self.store_dir)
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._procs = [
            ctx.Process(target=_serve,
                        args=(r, world_size, init, device, timeout, threads,
                              self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self.exitcodes: List[Optional[int]] = [None] * world_size

    def run(self, fn: Callable, *args, **kwargs) -> List:
        """``fn(*args, **kwargs)`` on every rank: the results in rank
        order.  Where a rank raises this raises with its traceback; where
        a rank exits, or gives no result within ``wait`` (or, once
        another has raised or exited, within ``GRACE`` seconds: it may
        wait on that one in a collective), the ranks are killed first and
        the error lists their exit codes (``exitcodes`` keeps them)."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out, errors, failed = {}, [], set()
        deadline = time.monotonic() + self.wait
        while len(out) + len(failed) < self.world_size:
            try:
                rank, ok, value = self._results.get(timeout=0.5)
            except queue.Empty:
                now = time.monotonic()
                dead = {r for r, p in enumerate(self._procs)
                        if not p.is_alive()} - set(out) - failed
                if dead:
                    errors.append(f"ranks {sorted(dead)} exited")
                    failed |= dead
                    deadline = min(deadline, now + self.GRACE)
                elif now > deadline:
                    errors.append(f"no result within {self.wait} s"
                                  if not failed else
                                  f"no result {self.GRACE} s after")
                    break
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                failed.add(rank)
                deadline = min(deadline, time.monotonic() + self.GRACE)
        if errors:
            if len(out) + len(failed) < self.world_size or any(
                    not p.is_alive() for p in self._procs):
                self.close(kill=True)
            codes = ", ".join(f"rank {r}: {c}" for r, c in
                              enumerate(self.exitcodes))
            raise RuntimeError(f"{fn.__name__} failed ({codes})\n"
                               + "\n".join(errors))
        return [out[r] for r in range(self.world_size)]

    def close(self, kill: bool = False) -> None:
        """Stop the ranks (idempotent); kill those that do not stop, or
        all of them at once with ``kill``."""
        for q, p in zip(self._tasks, self._procs):
            if kill:
                p.kill()
            elif p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self.exitcodes = [p.exitcode for p in self._procs] or self.exitcodes
        self._procs = []
        self._tasks = []
        if self._own_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
