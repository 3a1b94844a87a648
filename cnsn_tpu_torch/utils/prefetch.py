"""Host→device input prefetching: port of ``cnsn_tpu/utils/prefetch.py``.

The reference overlaps data loading with compute through DataLoader
worker processes (cifar.py:361-366).  Here, as in the JAX package, a
staging thread runs the loader and ``put`` for the next batches while the
current step runs.  On the card ``put`` is ``stage``: each array is
copied into pinned host memory and from there onto the card with
``non_blocking=True`` on a side stream, and an event marks the copy's
end.  The consumer makes its own stream wait on that event, and records
the batch's tensors on its stream so that the caching allocator does not
hand their memory to another copy before the step that reads them is
done.  On the CPU ``stage`` is a plain conversion.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["Staged", "batch_put", "device_prefetch", "stage"]

_END = object()


class Staged:
    """Tensors whose copy onto the card was issued on a side stream, and
    the event that marks its end."""

    def __init__(self, tensors: Sequence[torch.Tensor],
                 event: torch.cuda.Event):
        self.tensors = tuple(tensors)
        self.event = event

    def ready(self) -> tuple:
        """The tensors, usable on the current stream: it waits for the
        copy, and the allocator keeps their memory until the work queued
        on it so far is done."""
        current = torch.cuda.current_stream(self.tensors[0].device)
        current.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(current)
        return self.tensors


def stage(arrays: Sequence[np.ndarray], device: torch.device,
          stream: Optional[torch.cuda.Stream] = None):
    """``arrays`` on ``device``: on the CPU a tuple of tensors sharing
    their memory; on the card a ``Staged`` copy through pinned memory on
    ``stream`` (a side stream of that card)."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return tuple(host)
    with torch.cuda.stream(stream):
        out = [h.pin_memory().to(device, non_blocking=True) for h in host]
        event = torch.cuda.Event()
        event.record(stream)
    return Staged(out, event)


def batch_put(device: torch.device) -> Callable:
    """``device_prefetch``'s ``put`` for (images, labels) batches: both
    staged onto ``device``, the labels as int64, through a side stream of
    its own on the card."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        images, labels = batch
        return stage((images, np.asarray(labels, np.int64)), device, stream)

    return put


def _ready(item):
    return item.ready() if isinstance(item, Staged) else item


def device_prefetch(loader: Iterable, put: Callable,
                    depth: int = 2) -> Iterator:
    """Yield ``put(item)`` for each item of ``loader``, staged ``depth``
    batches ahead in a background thread.

    ``put`` runs in the worker thread (``stage`` for a host→device copy);
    a ``Staged`` result is made ready on the consumer's stream as it is
    yielded.  ``depth`` bounds the batches held staged; ``depth <= 0``
    disables staging (plain inline mapping).  Worker exceptions are
    re-raised at the consuming site, and a consumer that stops early
    releases the worker.
    """
    if depth <= 0:
        for item in loader:
            yield _ready(put(item))
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def enqueue(item) -> bool:
        # bounded put that notices consumer abandonment, so the worker
        # never parks forever holding staged batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in loader:
                if not enqueue(put(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            enqueue((_END, e))
            return
        enqueue((_END, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _END):
                if item[1] is not None:
                    raise item[1]
                return
            yield _ready(item)
    finally:
        # consumer done or abandoned (exception / early exit): release
        # the worker and drop any staged batches
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
