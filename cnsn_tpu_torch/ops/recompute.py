"""What a forward reads or draws that a recomputation must see again.

A rematerialised block (``models/remat.py``) runs its forward twice: once
in the forward pass, and again in the backward pass to rebuild the
activations it did not keep.  JAX's ``nn.remat`` recomputes from the same
inputs: the same ``batch_stats`` and the same per-site keys, and the
running statistics are updated once, by the first pass.  Here the layers
mutate state in place and draw from explicit generators, so the second
run would see the updated running mean (BatchNorm's K2 shift), update the
running statistics again and draw other CrossNorm partners and boxes.

A ``Replay`` is the record of one rematerialised call: on the first run
each value a layer takes through :func:`replayed` (BatchNorm's shift,
CrossNorm's draws) is made and kept, in order; on every later run the
same values come back in the same order, and :func:`recomputing` tells a
layer to leave its running statistics alone.  Outside a rematerialised
call both are no-ops.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional

__all__ = ["Replay", "recomputing", "replayed", "scope"]

# the Replay of the call running in this thread (the backward pass runs a
# recomputation in the autograd engine's thread, which sets its own)
_LOCAL = threading.local()


class Replay:
    """The values one rematerialised call took on its first run."""

    def __init__(self):
        self.values: list = []
        self.runs = 0
        self._next = 0

    @property
    def recomputing(self) -> bool:
        return self.runs > 1

    def begin(self) -> None:
        """Start a run: the first records, each later one replays from the
        first value."""
        self.runs += 1
        self._next = 0

    def take(self, make: Callable[[], Any]) -> Any:
        if not self.recomputing:
            value = make()
            self.values.append(value)
            return value
        value = self.values[self._next]
        self._next += 1
        return value


def current() -> Optional[Replay]:
    return getattr(_LOCAL, "replay", None)


@contextlib.contextmanager
def scope(replay: Replay):
    """Run a block under ``replay`` (one run of it: ``begin`` first)."""
    replay.begin()
    previous = current()
    _LOCAL.replay = replay
    try:
        yield replay
    finally:
        _LOCAL.replay = previous


def recomputing() -> bool:
    """True inside a recomputation: the running statistics stay as the
    first run left them."""
    replay = current()
    return replay is not None and replay.recomputing


def replayed(make: Callable[[], Any]) -> Any:
    """``make()``, except inside a recomputation, where the value the
    first run made at this point comes back."""
    replay = current()
    return make() if replay is None else replay.take(make)
