"""JAX checkpoint -> port state_dict, and LPIPS weights -> LPIPS state_dict.

Takes the JAX package's FeaturePredictor ``params`` and ``batch_stats`` as
nested dicts of numpy arrays (e.g. after ``jax.device_get``) and returns the
port's ``state_dict``. The port keeps the flax module names, so the map is
one to one apart from:

  * Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), transposed;
  * LayerNorm ``scale`` -> ``weight`` (a PTv3 block's norm1 / norm2; a
    SpUNet block's norm0 / norm1, beside its ``conv0_kernel``, are
    BatchNorms and keep ``scale``);
  * auto-named ``Dense_j`` -> ``fc{j+1}`` in a block MLP and ``linears.j``
    in an output head;
  * MaskedBatchNorm ``scale``/``bias`` and its ``mean``/``var`` statistics,
    and the conv kernels (27, Cin, Cout) (``cpe_conv_kernel``, the
    PT_embedding stem's ``embed_conv_kernel``, SpUNet's ``conv{j}_kernel``)
    with their biases, keep name and layout.

The port's ``batch_stats`` after a train step are its BatchNorm buffers
under the same names, so the map holds in both directions.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_LAYER_NORMS = ("norm1", "norm2")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _module_path(path: Tuple[str, ...]) -> list:
    out = []
    for i, part in enumerate(path):
        m = re.fullmatch(r"Dense_(\d+)", part)
        if m is None:
            out.append(part)
        elif path[i - 1] == "mlp":
            out.append(f"fc{int(m.group(1)) + 1}")
        elif path[i - 1].startswith("head_"):
            out.append(f"linears.{m.group(1)}")
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
    return out


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    conv_blocks = {path[:-1] for path, _ in _flatten(params)
                   if path[-1] == "conv0_kernel"}   # SpUNet's blocks
    for tree in (params, batch_stats or {}):
        for path, arr in _flatten(tree):
            mod, leaf = _module_path(path[:-1]), path[-1]
            if leaf == "kernel":
                leaf, arr = "weight", arr.T
            elif (leaf == "scale" and mod[-1] in _LAYER_NORMS
                  and path[:-2] not in conv_blocks):
                leaf = "weight"
            sd[".".join(mod + [leaf])] = torch.tensor(arr,
                                                      dtype=torch.float32)
    return sd


def lpips_state_dict_from_npz(data: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """LPIPS weights in the JAX package's npz layout (``vgg/conv{s}_{c}/
    kernel`` HWIO, ``.../bias``, ``lin{s}``; an ``np.load`` result or a
    dict) -> the port's LPIPS state_dict (``conv{s}_{c}.weight`` OIHW,
    ``.bias``, ``lin{s}``)."""
    sd: Dict[str, torch.Tensor] = {}
    for key in data:
        arr = np.asarray(data[key], np.float32)
        parts = key.split("/")
        if parts[0] == "vgg" and parts[-1] == "kernel":
            sd[f"{parts[1]}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif parts[0] == "vgg" and parts[-1] == "bias":
            sd[f"{parts[1]}.bias"] = torch.from_numpy(arr)
        elif len(parts) == 1 and re.fullmatch(r"lin\d", key):
            sd[key] = torch.from_numpy(arr)
        else:
            raise KeyError(f"no LPIPS counterpart for {key}")
    return sd
