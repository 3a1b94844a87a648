"""Debug-mode numerics guard: port of ``cnsn_tpu/utils/debug.py``.

``checked(fn)`` is the counterpart of JAX's ``checkify`` with
``float_checks``: the wrapped step raises a Python error, naming the op,
where any floating intermediate of it (forward, backward and optimizer
update alike) is NaN or Inf, instead of going on with a corrupt state.
A ``TorchDispatchMode`` sees every aten op's floating outputs (views and
uninitialised allocations aside) and keeps, on the device, whether each
was finite; the hand-written kernels (K1–K4), which write their outputs
through ctypes where no op sees them, report theirs through
``ops/kernels/_build.py::WATCHERS``.  The step then takes one host sync
to read the flags.  The values the step computes are unchanged; the state
it updated in place stays as the step left it.  Debug only, with no
config knob, as in JAX: it costs two small kernels per op output.
"""
from __future__ import annotations

import functools
from typing import Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops.kernels._build import WATCHERS

__all__ = ["NonFiniteError", "checked"]

# allocations whose contents are whatever memory held (a kernel or a copy
# fills them afterwards)
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "empty_permuted",
                  "new_empty", "new_empty_strided"}


class NonFiniteError(FloatingPointError):
    """A step produced NaN or Inf; ``op`` names the first op that did."""

    def __init__(self, op: str, index: int, total: int):
        super().__init__(f"non-finite value (NaN or Inf) first produced by "
                         f"{op} (output {index} of {total} checked)")
        self.op = op


class _FiniteWatch(TorchDispatchMode):
    """Records, per floating op output, a device flag: all finite."""

    def __init__(self):
        super().__init__()
        self.names: List[str] = []
        self.flags: List[torch.Tensor] = []
        self._noting = False

    def note(self, name: str, tensors) -> None:
        # a watcher calls this outside __torch_dispatch__, where the
        # flags' own ops would come back through the mode
        self._noting = True
        try:
            for t in tensors:
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.numel()):
                    self.flags.append(torch.isfinite(t).all())
                    self.names.append(name)
        finally:
            self._noting = False

    def kernel(self, name: str, outputs) -> None:
        self.note(f"{name} (hand-written kernel)", outputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if (self._noting or func.is_view
                or packet.__name__ in _UNINITIALISED):
            return out
        tensors = tree_leaves(out)
        if func._schema.is_mutable and args:
            # in-place and foreach updates return the mutated arguments or
            # nothing
            tensors += tree_leaves(args[0])
        self.note(str(packet), tensors)
        return out

    def first_bad(self):
        """(op name, index) of the first non-finite output, or None; one
        host sync per device."""
        by_device = {}
        for i, flag in enumerate(self.flags):
            by_device.setdefault(flag.device, []).append(i)
        bad = []
        for idx in by_device.values():
            ok = torch.stack([self.flags[i] for i in idx]).cpu()
            bad += [idx[j] for j in (~ok).nonzero().flatten().tolist()[:1]]
        if not bad:
            return None
        first = min(bad)
        return self.names[first], first


def checked(fn: Callable) -> Callable:
    """Wrap a step function; it raises ``NonFiniteError`` on NaN or Inf in
    any floating intermediate.  Usage::

        step = checked(steps.plain)   # debug runs
        state, metrics = step(state, images, labels)
    """
    @functools.wraps(fn)
    def run(*args, **kwargs):
        watch = _FiniteWatch()
        WATCHERS.append(watch.kernel)
        try:
            with watch:
                out = fn(*args, **kwargs)
        finally:
            WATCHERS.remove(watch.kernel)
        found = watch.first_bad()
        if found is not None:
            raise NonFiniteError(found[0], found[1], len(watch.flags))
        return out

    return run
