"""Carry weights over from the JAX package's parameter trees.

``state_dict_from_jax(params, batch_stats)`` is the inverse of
``cnsn_tpu/utils/torch_import.py::_translate`` for ResNet trees: it takes
the JAX trees as nested dicts of arrays (numpy, or anything
``np.array`` reads) and returns a torch state dict in the reference's
key names and layouts, which the port's modules load with
``load_state_dict``:

  path  layer1_0 → layer1.0;  downsample_conv/_bn → downsample.0/.1
  conv  kernel (kH, kW, I, O)  → weight (O, I, kH, kW)
  dense kernel (in, out)       → weight (out, in)
  norm  scale / bias           → weight / bias
  stats mean / var             → running_mean / running_var
  SelfNorm g_fc (C, 2)         → g_fc.weight (C, 1, 2)
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_BLOCK = re.compile(r"^(layer\d+)_(\d+)$")
_DOWNSAMPLE = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _module_key(path) -> str:
    parts = []
    for p in path:
        m = _BLOCK.match(p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m
                     else _DOWNSAMPLE.get(p, p))
    return ".".join(parts)


def _leaves(tree: Mapping[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path, k, np.array(v, dtype=np.float32)  # a writable copy


def _join(mod: str, leaf: str) -> str:
    return f"{mod}.{leaf}" if mod else leaf


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, v in _leaves(params):
        mod = _module_key(path)
        if leaf == "kernel" and v.ndim == 4:
            key, v = _join(mod, "weight"), v.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and v.ndim == 2:
            key, v = _join(mod, "weight"), v.T
        elif leaf == "scale":
            key = _join(mod, "weight")
        elif leaf == "bias":
            key = _join(mod, "bias")
        elif leaf == "g_fc":
            key, v = _join(_join(mod, "g_fc"), "weight"), v[:, None, :]
        else:
            raise KeyError(f"no torch name for param "
                           f"{'/'.join(path + (leaf,))}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(v))
    for path, leaf, v in _leaves(batch_stats):
        if leaf not in _STATS:
            raise KeyError(f"no torch name for batch stat "
                           f"{'/'.join(path + (leaf,))}")
        sd[_join(_module_key(path), _STATS[leaf])] = torch.from_numpy(
            np.ascontiguousarray(v))
    return sd
