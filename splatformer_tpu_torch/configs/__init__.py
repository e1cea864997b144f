"""Config system (port of splatformer_tpu/configs/__init__.py): three tiers
of python configs (model / dataset / train), each a module
``{kind}_{name}.py`` whose ``get_config()`` returns a dataclass, with
``a.b.c=value`` CLI overrides.

The port has the configs it runs: ``model ptv3_base``, the datasets
``synthetic``, ``oodbench``, ``oodbench_scale``, ``oodbench_512``,
``objaverse`` and ``shapenet``, and ``train default``. Loading any other
name raises NotImplementedError (the JAX package's other model configs are
queued in ROADMAP.md). An override of a field that does not exist raises;
keys of a dict field (``train.optimizer.lr_dict.means=1e-4``,
``dataset.test.folders``) may be added.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import json
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

from splatformer_tpu_torch.configs.dataset_synthetic import DatasetConfig
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.scene_dataset import SceneDatasetConfig
from splatformer_tpu_torch.configs.train_default import TrainConfig


@dataclass
class FullConfig:
    model: ModelConfig
    dataset: Union[DatasetConfig, SceneDatasetConfig]
    train: TrainConfig

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)


def load_config(kind: str, name: str) -> Any:
    """kind in {model, dataset, train}; name like 'ptv3_base' (or a path
    to the JAX package's config file of that name)."""
    if name.endswith(".py"):
        name = name.rsplit("/", 1)[-1][:-3]
    module = f"splatformer_tpu_torch.configs.{kind}_{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise NotImplementedError(
            f"{kind} config {name!r} is not ported yet (see ROADMAP.md, "
            "queue 1)") from None
    return mod.get_config()


def _check_field(node: Any, name: str, key: str) -> None:
    if not isinstance(node, dict) and name not in {
            f.name for f in dataclasses.fields(node)}:
        raise KeyError(f"config override {key!r}: no field {name!r}")


def apply_overrides(cfg: Any, overrides: Optional[Sequence[str]]) -> Any:
    """Apply 'a.b.c=value' strings (values parsed as python literals, else
    kept as strings) to a dataclass config in place; returns it."""
    for item in overrides or ():
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        *parents, last = key.strip().split(".")
        node = cfg
        for p in parents:
            _check_field(node, p, key)
            node = node[p] if isinstance(node, dict) else getattr(node, p)
        _check_field(node, last, key)
        if isinstance(node, dict):
            node[last] = value
            continue
        if isinstance(getattr(node, last), tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(node, last, value)
    return cfg


def build_full_config(model: str = "ptv3_base", dataset: str = "synthetic",
                      train: str = "default",
                      overrides: Optional[Sequence[str]] = None
                      ) -> FullConfig:
    cfg = FullConfig(model=load_config("model", model),
                     dataset=load_config("dataset", dataset),
                     train=load_config("train", train))
    return apply_overrides(cfg, overrides)
