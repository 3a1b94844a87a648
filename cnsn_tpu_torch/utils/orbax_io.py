"""Step checkpoints with asynchronous saves, keep-N retention and a
SIGTERM flush: port of ``cnsn_tpu/utils/orbax_io.py``, the Trainers'
``ckpt_backend: orbax``, without orbax.

A checkpoint is the directory ``<directory>/<step>/`` holding one
``torch.save`` file: the model's state dict (parameters and running
statistics), the optimizer's (momentum buffers), the update count
``step``, a free-form ``extra`` dict the host loop owns (epoch,
best_acc) and the ``metrics`` it was saved with.  A save writes a
temporary directory and renames it, so a half-written step is never
listed.  The format is the port's own: neither package reads the other's
checkpoints.

As orbax's manager does, a save at a step not above the newest one (saved
or in flight) is skipped, and after each save only the newest ``keep``
steps stay.  A save copies the state to the host before it returns, so
the next step may mutate the state in place; only the file write runs in
a background thread, one at a time.

``install_preemption_save``: the JAX handler saves from inside the signal
handler, which is sound there because JAX's state is immutable.  Here the
optimizer updates the parameters in place, so the handler only marks the
signal while a step runs; the step's end (``PreemptionSave.step``) then
flushes.  Outside a step it flushes at once.  The flush waits for any
save in flight, saves synchronously, runs ``before_exit`` (the Trainer's
``close``: its worker processes, which ``os._exit`` would orphan) and
exits with ``exit_code``.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import signal
import sys
import threading
from typing import Callable, List, Optional

import torch

__all__ = ["OrbaxCheckpointer", "PreemptionSave", "install_preemption_save"]

_FILE = "state.pt"


def _host_copy(tree):
    """``tree`` with every tensor copied to the host (a CPU tensor too: a
    later in-place update must not reach the copy)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


class OrbaxCheckpointer:
    """Step checkpoints of a train state (``model``, ``optimizer``,
    ``step``) under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._in_flight: Optional[int] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> List[int]:
        """The complete checkpoints' steps, ascending (a leftover
        temporary directory is not one)."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, extra: Optional[dict] = None,
             metrics: Optional[dict] = None, wait: bool = False) -> bool:
        """Save ``state`` as ``step`` in the background (``wait``: before
        returning); False, and nothing saved, where ``step`` is not above
        the newest step saved or in flight."""
        newest = max([s for s in (self.latest_step(), self._in_flight)
                      if s is not None], default=None)
        if newest is not None and step <= newest:
            if wait:
                self.wait_until_finished()
            return False
        payload = {"model": _host_copy(state.model.state_dict()),
                   "optimizer": _host_copy(state.optimizer.state_dict()),
                   "step": int(state.step), "extra": dict(extra or {}),
                   "metrics": dict(metrics or {})}
        self.wait_until_finished()
        self._in_flight = step
        self._thread = threading.Thread(target=self._write,
                                        args=(step, payload), daemon=True)
        self._thread.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step: int, payload: dict) -> None:
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _FILE))
            os.rename(tmp, os.path.join(self.directory, str(step)))
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except BaseException as e:  # noqa: BLE001 — raised by the waiter
            self._error = e
            shutil.rmtree(tmp, ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._in_flight = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, state, step: Optional[int] = None,
                extra_template: Optional[dict] = None):
        """Load ``step`` (default the newest) into ``state`` in place:
        (state, step, extra), ``extra`` the saved dict over
        ``extra_template``; (state, None, {}) where there is none."""
        self.wait_until_finished()
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, None, {}
        payload = torch.load(os.path.join(self.directory, str(step), _FILE),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, step, {**(extra_template or {}), **payload["extra"]}

    def close(self) -> None:
        self.wait_until_finished()


class PreemptionSave:
    """The SIGTERM handler of ``install_preemption_save``: a synchronous
    save of ``get_state()`` = (step, state) with ``get_extra()``, at a step
    boundary, then ``before_exit()`` and ``os._exit(exit_code)``.  Wrap
    every call that mutates the state in ``step()``."""

    def __init__(self, get_state: Callable, checkpointer: OrbaxCheckpointer,
                 get_extra: Optional[Callable] = None,
                 exit_code: Optional[int] = None,
                 before_exit: Optional[Callable] = None):
        self.get_state = get_state
        self.checkpointer = checkpointer
        self.get_extra = get_extra
        self.exit_code = exit_code
        self.before_exit = before_exit
        self._in_step = False
        self._pending = False
        self._done = False

    def handler(self, signum, frame) -> None:
        if self._in_step:
            self._pending = True
        else:
            self.flush()

    @contextlib.contextmanager
    def step(self):
        """A block that mutates the state: a SIGTERM inside it is flushed
        when it ends."""
        self._in_step = True
        try:
            yield
        finally:
            self._in_step = False
        if self._pending:
            self.flush()

    def flush(self) -> None:
        if self._done:
            return
        self._done = True
        step, state = self.get_state()
        extra = self.get_extra() if self.get_extra is not None else None
        self.checkpointer.save(int(step), state, extra=extra, wait=True)
        if self.before_exit is not None:
            self.before_exit()
        if self.exit_code is not None:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(self.exit_code)


def install_preemption_save(get_state: Callable,
                            checkpointer: OrbaxCheckpointer,
                            get_extra: Optional[Callable] = None,
                            exit_code: Optional[int] = None,
                            before_exit: Optional[Callable] = None
                            ) -> PreemptionSave:
    """SIGTERM → a final synchronous save, then (with ``exit_code``) the
    process ends: the preemption contract (SLURM and GKE send SIGTERM,
    then SIGKILL after a grace period), so a run never resumes on a
    half-done step.  Returns the installed ``PreemptionSave``."""
    guard = PreemptionSave(get_state, checkpointer, get_extra, exit_code,
                           before_exit)
    signal.signal(signal.SIGTERM, guard.handler)
    return guard
