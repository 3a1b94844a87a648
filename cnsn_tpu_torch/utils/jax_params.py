"""Carry weights over from the JAX package's parameter trees.

``state_dict_from_jax(params, batch_stats, key_map=None)`` is the inverse
of ``cnsn_tpu/utils/torch_import.py::_translate`` for ResNet, ResNet-IBN,
WideResNet, DenseNet, ResNeXt and (with ``key_map``) AllConvNet and
the segmentation trees (FCN, PSPNet, PSANet, PSALite: ``SEG_KEY_MAP``):
it takes the
JAX trees as nested dicts of arrays (numpy, or anything ``np.array``
reads) and returns a torch state dict in the reference's key names and
layouts, which the port's modules load with ``load_state_dict``:

  path  layer1_0 → layer1.0;  block1_0 → block1.layer.0 (WideResNet);
        dense1_0 → dense1.0, trans1_bn/_conv → trans1.bn1/.conv1
        (DenseNet); stage1_0 → stage_1.0 (ResNeXt);
        downsample_conv/_bn → downsample.0/.1;  IBN's children and the
        post-add InstanceNorm keep their names (layer1_0/bn1/IN →
        layer1.0.bn1.IN, layer1_2/IN → layer1.2.IN);  a top-level name in
        ``key_map``'s values → its key (AllConvNet: conv_0 → features.0
        through ``models/allconv.py::allconv_key_map(pos)``, the map
        ``convert_state_dict`` takes the other way)
  conv  kernel (kH, kW, I/groups, O)  → weight (O, I/groups, kH, kW)
  dense kernel (in, out)       → weight (out, in)
  norm  scale / bias           → weight / bias
  stats mean / var             → running_mean / running_var
  SelfNorm g_fc (C, 2)         → g_fc.weight (C, 1, 2)  (and is_two's
           f_fc (C, 2)         → f_fc.weight; f_bn as any norm)
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["PSA_KEY_MAP", "PSP_KEY_MAP", "SEG_KEY_MAP", "state_dict_from_jax"]

_HEAD = (("0", "conv1"), ("1", "bn1"), ("4", "conv2"))
# the FCN heads: torchvision FCNHead's Sequential indices → the JAX
# FCNHead's names (cnsn_tpu/segmentation/fcn.py:27-41)
_FCN_KEY_MAP = {f"{head}.{idx}": f"{head}.{name}"
               for head in ("classifier", "aux_classifier")
               for idx, name in _HEAD}
# PSPNet's heads (reference pspnet.py: ppm.features.j = Sequential(pool,
# conv, bn, relu); cls/aux Sequentials) → the JAX PPM's conv_j/bn_j and
# _ClsHead's names (cnsn_tpu/segmentation/pspnet.py:63-97); the cls/aux
# entries serve PSANet and PSALite too (PSALite's psa_* keep their names)
PSP_KEY_MAP = {
    **{f"ppm.features.{j}.{idx}": f"ppm.{name}_{j}"
       for j in range(4) for idx, name in (("1", "conv"), ("2", "bn"))},
    **{f"{head}.{idx}": f"{head}.{name}"
       for head in ("cls", "aux") for idx, name in _HEAD}}
# PSANet's PSA module (reference psanet.py: reduce, attention, proj
# Sequentials) → the JAX PSA's names (pspnet.py:209-225)
PSA_KEY_MAP = {
    f"psa.{side}{suffix}.{idx}": f"psa.{side}{suffix}_{name}"
    for suffix in ("", "_p")
    for side, parts in (("reduce", (("0", "conv"), ("1", "bn"))),
                        ("attention", (("0", "conv1"), ("1", "bn"),
                                       ("3", "conv2"))))
    for idx, name in parts}
PSA_KEY_MAP.update({"psa.proj.0": "psa.proj_conv",
                    "psa.proj.1": "psa.proj_bn"})
# every segmentation arch's heads: the prefixes do not overlap
SEG_KEY_MAP = {**_FCN_KEY_MAP, **PSP_KEY_MAP, **PSA_KEY_MAP}

# JAX module name → torch path, by pattern (first match wins)
_PATHS = ((re.compile(r"^(layer\d+|dense\d+)_(\d+)$"), r"\1.\2"),
          (re.compile(r"^(block\d+)_(\d+)$"), r"\1.layer.\2"),
          (re.compile(r"^stage(\d+)_(\d+)$"), r"stage_\1.\2"),
          (re.compile(r"^(trans\d+)_(bn|conv)$"), r"\1.\g<2>1"))
_DOWNSAMPLE = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _module_key(path, top: Mapping[str, str]) -> str:
    parts = []
    for n in range(len(path), 0, -1):  # the longest mapped leading path
        lead = ".".join(path[:n])
        if lead in top:
            parts.append(top[lead])
            path = path[n:]
            break
    for p in path:
        for pattern, repl in _PATHS:
            if pattern.match(p):
                parts.append(pattern.sub(repl, p))
                break
        else:
            parts.append(_DOWNSAMPLE.get(p, p))
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
                        batch_stats: Mapping[str, Any],
                        key_map: Optional[Mapping[str, str]] = None
                        ) -> Dict[str, torch.Tensor]:
    """``key_map``: torch prefix → JAX module path (dotted), the map
    ``convert_state_dict`` takes (AllConvNet's ``allconv_key_map(pos)``,
    the segmentation heads' ``SEG_KEY_MAP``)."""
    top = {jax_name: prefix for prefix, jax_name in (key_map or {}).items()}
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, v in _leaves(params):
        mod = _module_key(path, top)
        if leaf == "kernel" and v.ndim == 4:
            key, v = _join(mod, "weight"), v.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and v.ndim == 2:
            key, v = _join(mod, "weight"), v.T
        elif leaf == "scale":
            key = _join(mod, "weight")
        elif leaf == "bias":
            key = _join(mod, "bias")
        elif leaf in ("g_fc", "f_fc"):
            key, v = _join(_join(mod, leaf), "weight"), v[:, None, :]
        else:
            raise KeyError(f"no torch name for param "
                           f"{'/'.join(path + (leaf,))}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(v))
    for path, leaf, v in _leaves(batch_stats):
        if leaf not in _STATS:
            raise KeyError(f"no torch name for batch stat "
                           f"{'/'.join(path + (leaf,))}")
        sd[_join(_module_key(path, top), _STATS[leaf])] = torch.from_numpy(
            np.ascontiguousarray(v))
    return sd
