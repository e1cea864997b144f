"""JAX checkpoint -> port state_dict.

Takes the JAX package's FeaturePredictor ``params`` and ``batch_stats`` as
nested dicts of numpy arrays (e.g. after ``jax.device_get``) and returns the
port's ``state_dict``. The port keeps the flax module names, so the map is
one to one apart from:

  * Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), transposed;
  * LayerNorm ``scale`` -> ``weight`` (norm1 / norm2);
  * auto-named ``Dense_j`` -> ``fc{j+1}`` in a block MLP and ``linears.j``
    in an output head;
  * MaskedBatchNorm ``scale``/``bias`` and its ``mean``/``var`` statistics,
    and the xCPE ``cpe_conv_kernel`` (27, Cin, Cout), keep name and layout.
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
    for tree in (params, batch_stats or {}):
        for path, arr in _flatten(tree):
            mod, leaf = _module_path(path[:-1]), path[-1]
            if leaf == "kernel":
                leaf, arr = "weight", arr.T
            elif leaf == "scale" and mod[-1] in _LAYER_NORMS:
                leaf = "weight"
            sd[".".join(mod + [leaf])] = torch.tensor(arr,
                                                      dtype=torch.float32)
    return sd
