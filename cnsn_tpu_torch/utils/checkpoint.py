"""Checkpoint save/restore with best-copy semantics: port of
``cnsn_tpu/utils/checkpoint.py`` (reference: utils.py:34-42
save_checkpoint; cifar.py:415-430 resume).

One ``torch.save`` file holding {epoch, best_acc, state_dict, optimizer,
step}: ``state_dict`` is the model's (parameters and running statistics)
in the reference's key names on the CPU, the layout the reference's own
checkpoints have and ``cnsn_tpu/utils/torch_import.py::
import_torch_checkpoint`` reads, so a port checkpoint initialises the JAX
``Trainer`` through ``pretrained=``; ``optimizer`` is the SGD state (the
momentum buffers); ``step`` the updates taken, from which the learning
rate schedule continues.  '<Model>_last_ckpt', plus a '<Model>_best_ckpt'
copy when the accuracy improves and '<Model>_ckpt_<epoch>' on request.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "restore_state"]


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(state, model_name: str, save_dir: str, epoch: int,
                    best_acc: float, is_best: bool,
                    keep_epoch_file: bool = False) -> str:
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "epoch": epoch,
        "best_acc": float(best_acc),
        "state_dict": _cpu(state.model.state_dict()),
        "optimizer": _cpu(state.optimizer.state_dict()),
        "step": int(state.step),
    }
    path = os.path.join(save_dir, f"{model_name}_last_ckpt")
    torch.save(payload, path)
    if keep_epoch_file:
        shutil.copyfile(path, os.path.join(save_dir,
                                           f"{model_name}_ckpt_{epoch}"))
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir,
                                           f"{model_name}_best_ckpt"))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint file, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(path: str, state) -> Tuple[Any, int, float]:
    """Restore a TrainState in place from a checkpoint file: weights and
    running statistics, momentum buffers (onto the parameters' device)
    and the update count.  Returns (state, start_epoch, best_acc)."""
    payload = load_checkpoint(path)
    state.model.load_state_dict(payload["state_dict"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), float(payload["best_acc"])
