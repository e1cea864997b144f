"""The port's config stack (configs/__init__.py and its dataclass configs)
against the JAX package's ml_collections configs: every field of
ptv3_base / synthetic / default, as built and after the same overrides.
Configs only, nothing compiled."""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

from splatformer_tpu.configs import build_full_config as jax_full_config  # noqa: E402
from splatformer_tpu_torch.configs import (apply_overrides,  # noqa: E402
                                           build_full_config, load_config)


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _norm(v)
    return out


def both(overrides=None):
    j = _flat(jax_full_config("ptv3_base", "synthetic", "default",
                              overrides).to_dict())
    p = _flat(dataclasses.asdict(build_full_config(
        "ptv3_base", "synthetic", "default", overrides)))
    return j, p


OVERRIDES = [
    "train.optimizer.type='sgd'", "train.optimizer.lr_dict.base=1e-3",
    "train.optimizer.lr_dict.means=1e-4", "train.lpips_weights_path=''",
    "train.eval_interval=50", "train.bf16=False",
    "train.optimizer.finetune_filter=('attn/qkv',)",
    "model.backbone.enable_flash=True", "model.backbone.enc_channels=(8, 16)",
    "model.additional_info.r=0.0", "dataset.background_color=(255, 255, 255)",
    "dataset.n_gaussians=100000", "dataset.pad_to=100352",
]


@pytest.mark.parametrize("overrides", [None, OVERRIDES],
                         ids=["defaults", "overrides"])
def test_every_jax_field_matches(overrides):
    """Each field of the JAX configs exists in the port's with the same
    value; the port's only extra field is the dataset's num_workers, which
    the JAX loop reads with a default of 0."""
    j, p = both(overrides)
    assert set(j) <= set(p), sorted(set(j) - set(p))
    assert set(p) - set(j) == {"dataset.num_workers"}
    for k in j:
        assert p[k] == j[k], (k, p[k], j[k])
    assert p["dataset.num_workers"] == 0


def test_override_parsing():
    cfg = build_full_config(overrides=[
        "train.lpips_weights_path=weights/x.npz",   # not a literal: a string
        "model.backbone.stride=[1, 2]",            # a list onto a tuple field
        "train.optimizer.lr_dict.scales=5e-5"])    # a new key of a dict
    assert cfg.train.lpips_weights_path == "weights/x.npz"
    assert cfg.model.backbone.stride == (1, 2)
    assert cfg.train.optimizer.lr_dict == {"base": 3e-5, "backbone": 3e-5,
                                           "scales": 5e-5}
    assert json.loads(cfg.to_json())["train"]["optimizer"]["lr_dict"][
        "scales"] == 5e-5


@pytest.mark.parametrize("bad", ["train.no_such_field=1",
                                 "model.backbone.no_such=2",
                                 "nothing.at_all=3"])
def test_unknown_field_raises(bad):
    with pytest.raises(KeyError):
        apply_overrides(build_full_config(), [bad])


@pytest.mark.parametrize("kind,name", [("model", "ptv3_no_such"),
                                       ("model", "no_such_model"),
                                       ("train", "no_such_recipe"),
                                       ("dataset", "no_such_set")])
def test_unported_config_raises(kind, name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_config(kind, name)


def test_config_file_path_names_resolve():
    assert load_config("model", "configs/model/ptv3_base.py") == load_config(
        "model", "ptv3_base")


MODEL_VARIANTS = ["ptv3_algm", "ptv3_drop", "ptv3_fps", "ptv3_patch",
                  "ptv3_pitome", "ptv3_prune", "ptv3_tofu", "ptv3_tome",
                  "ptv3_voxel", "ptv3_wpatch", "spunet"]


@pytest.mark.parametrize("name", MODEL_VARIANTS)
def test_model_variant_matches_jax(name):
    """Every JAX model config loads in the port and equals the JAX one
    field by field (additional_info's merging and downsampling keys,
    spunet's backbone_type and sp_backbone), in the full config beside the
    synthetic dataset and the default recipe."""
    j = _flat(jax_full_config(name, "synthetic", "default").to_dict())
    p = _flat(dataclasses.asdict(build_full_config(name, "synthetic",
                                                   "default")))
    assert set(p) - set(j) == {"dataset.num_workers"}
    assert set(j) <= set(p), sorted(set(j) - set(p))
    for k in j:
        assert p[k] == j[k], (k, p[k], j[k])
    info = load_config("model", name).additional_info
    assert (info["tome"] != "base") + bool(info.get("downsample")) + (
        name == "spunet") == 1
