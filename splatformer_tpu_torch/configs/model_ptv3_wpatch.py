"""PTv3 variant 'wpatch' (copy of splatformer_tpu/configs/model_ptv3_wpatch.py,
after the reference's configs/model/ptv3_wpatch.gin): PTv3-base with these
``additional_info`` entries."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.additional_info["tome"] = "wpatch"
    cfg.additional_info["r"] = 0.5
    cfg.additional_info["stride"] = 10
    cfg.additional_info["low_r"] = 16
    return cfg
