"""How far a float32 training run lies from its float64 twin, and where
the distance enters.

The run is three SGD steps (plain, cn_image with a fixed permutation,
plain) of a reduced-depth ResNet-50+SN (layers (1, 1, 1, 1), full widths,
b=4 64², 10 classes, SelfNorm at pos='post'), from seeded weights and
data, in any type on any device.

Two float32 runs of the same steps (the card's and the CPU's, say) round
differently, and wherever an activation lies within that rounding of 0 a
ReLU passes the gradient in one run and blocks it in the other: that
element's gradient then differs by its whole value, and later steps carry
the difference on.  So a float32 run is compared with a float64 run that
*replays its ReLU masks and max-pool choices* (``run_steps(replay=...)``):
both then compute the same piecewise-linear function, and what is left
between them is rounding alone.

    python -m cnsn_tpu_torch.train.rounding [--device cuda|cpu]

prints one JSON line: for the float32 run on ``--device`` and for the
CPU's, the error against its replaying float64 twin, and, for step 1
against a float64 run with its own masks, each module's forward and
gradient error from the loss back to the stem and the ReLU inputs whose
sign differs.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F

from ..models import build_model
from ..models import resnet as _resnet
from ..utils.device import resolve_device
from .schedules import cosine_lr
from .steps import StepFns, create_train_state

__all__ = ["KINDS", "Run", "compare_runs", "compare_traces", "run_steps"]

KINDS = ("plain", "cn_image", "plain")
BATCH, SIZE, CLASSES = 4, 64, 10  # 64² leaves layer4 at 2x2
PERM = (2, 0, 3, 1)  # the cn_image step's partner of each instance


class _Tape:
    """Stands in for ``torch.nn.functional`` inside ``models/resnet.py``.
    Without ``replay`` it records every ReLU's mask and every max-pool's
    choice; with the record of another run it applies those instead."""

    def __init__(self, replay: Optional[list] = None):
        self.replay = replay
        self.record: list = []

    def _next(self):
        return self.replay[len(self.record)]

    def relu(self, x):
        if self.replay is None:
            self.record.append((x > 0).cpu())
            return F.relu(x)
        mask = self._next()
        self.record.append(mask)
        return x * mask.to(x.device, x.dtype)

    def max_pool2d(self, x, kernel, stride, padding):
        if self.replay is None:
            out, idx = F.max_pool2d(x, kernel, stride, padding,
                                    return_indices=True)
            self.record.append(idx.cpu())
            return out
        idx = self._next()
        self.record.append(idx)
        n, c = idx.shape[:2]
        out = x.reshape(n, c, -1).gather(
            2, idx.reshape(n, c, -1).to(x.device)).reshape(idx.shape)
        return out.contiguous(memory_format=torch.channels_last)


@dataclass
class Run:
    """One run of ``KINDS``: each step's loss, the state after steps 1
    and 3 (parameters, running statistics and ``momentum.``-prefixed
    momentum buffers, on the CPU in the run's type), the tape of ReLU
    masks and max-pool choices, and, traced, step 1's output and output
    gradient of every module."""
    losses: list
    states: dict
    tape: list
    trace: dict = field(default_factory=dict)


def _snapshot(state) -> dict:
    out = {k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    out.update({"momentum." + n: opt.state[p]["momentum_buffer"].detach()
                .cpu().clone() for n, p in state.model.named_parameters()})
    return out


def _trace_hooks(model, trace: dict) -> list:
    def hook(name):
        def record(module, inputs, out):
            trace[name] = [out.detach().cpu(), None]
            if out.requires_grad:
                out.register_hook(
                    lambda g: trace[name].__setitem__(1, g.detach().cpu()))
        return record
    return [m.register_forward_hook(hook(n))
            for n, m in model.named_modules() if n]


def run_steps(device: str | torch.device, dtype: torch.dtype, *,
              replay: Optional[list] = None, trace: bool = False) -> Run:
    """The three steps on ``device`` (TF32 off) in ``dtype`` (float32 or
    float64, the whole model).  ``replay``: the tape of another run, whose
    ReLU masks and max-pool choices this run applies."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(len(KINDS), BATCH, SIZE, SIZE, 3, generator=gen)
    labels = torch.randint(0, CLASSES, (len(KINDS), BATCH), generator=gen)
    model = build_model("resnet50", CLASSES,
                        generator=torch.Generator().manual_seed(0),
                        layers=(1, 1, 1, 1), pos="post", cnsn_type="sn")
    state = create_train_state(model.to(dtype), cosine_lr(0.05, 4),
                               momentum=0.9, weight_decay=1e-4,
                               nesterov=False, device=device)
    steps, tape, traced = StepFns(), _Tape(replay), {}
    handles = _trace_hooks(state.model, traced) if trace else []
    losses, states = [], {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _resnet.F = tape
    try:
        for i, kind in enumerate(KINDS):
            x = images[i].to(device, dtype)
            y = labels[i].to(device)
            if kind == "plain":
                state, metrics = steps.plain(state, x, y)
            else:
                state, metrics = steps.cn_image(
                    state, x, y, perm=torch.tensor(PERM, device=device))
            losses.append(float(metrics["loss"]))
            for h in handles:
                h.remove()
            handles = []
            if i in (0, len(KINDS) - 1):
                states[i + 1] = _snapshot(state)
    finally:
        _resnet.F = F
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return Run(losses, states, tape.record, traced)


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    want = want.double()
    return (float((got.double() - want).abs().max())
            / max(float(want.abs().max()), 1e-30))


def compare_runs(run: Run, ref: Run) -> dict:
    """Errors of ``run`` against ``ref``: each step's loss (relative), and
    after steps 1 and 3 the worst tensor of the state and of the momentum
    buffers (each over that tensor's max-abs), with its name."""
    out = {"loss_rel_err": [abs(a - b) / abs(b)
                            for a, b in zip(run.losses, ref.losses)]}
    for step, want in ref.states.items():
        got = run.states[step]
        for part, keep in (("state", lambda k: not k.startswith("momentum.")),
                           ("momentum", lambda k: k.startswith("momentum."))):
            out[f"step{step}_{part}"] = max(
                (_rel_max(got[k], want[k]), k) for k in want if keep(k))
    return out


def _relu_input(name: str) -> bool:
    """Modules whose output goes into a ReLU: the stem's BN, each
    bottleneck's bn1 and bn2, and its SelfNorm (pos='post')."""
    return name == "bn1" or name.endswith((".bn1", ".bn2", ".cnsn"))


def compare_traces(run: Run, ref: Run) -> list:
    """Step 1, module by module from the loss back to the stem: the error
    of the output and of its gradient against ``ref``; at each ReLU input,
    the elements whose sign differs and the gradient's error over the
    other elements alone."""
    rows = []
    for name in reversed(list(ref.trace)):
        (out, grad), (want, want_g) = run.trace[name], ref.trace[name]
        row = {"module": name, "fwd_err": _rel_max(out, want)}
        if want_g is not None:
            row["grad_err"] = _rel_max(grad, want_g)
        if _relu_input(name) and want_g is not None:
            agree = (out > 0) == (want > 0)
            row["sign_flips"] = int((~agree).sum())
            scale = max(float(want_g.double().abs().max()), 1e-30)
            row["grad_err_where_signs_agree"] = float(
                ((grad.double() - want_g.double()) * agree).abs().max()) / scale
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    devices = [resolve_device(args.device)]
    if devices[0].type != "cpu":
        devices.append(torch.device("cpu"))
    ref = run_steps("cpu", torch.float64, trace=True)
    result = {}
    for device in devices:
        run = run_steps(device, torch.float32, trace=True)
        twin = run_steps("cpu", torch.float64, replay=run.tape)
        result[f"{device.type}_f32"] = {
            "vs_replaying_f64": compare_runs(run, twin),
            "vs_own_f64": compare_runs(run, ref),
            "step1_by_module": compare_traces(run, ref)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
