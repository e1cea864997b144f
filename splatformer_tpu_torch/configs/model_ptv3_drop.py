"""PTv3 variant 'drop' (copy of splatformer_tpu/configs/model_ptv3_drop.py,
after the reference's configs/model/ptv3_drop.gin): PTv3-base with these
``additional_info`` entries."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.additional_info["downsample"] = "random"
    cfg.additional_info["downsample_ratio"] = 0.6
    return cfg
