"""PTv3 variant 'pitome' (copy of splatformer_tpu/configs/model_ptv3_pitome.py,
after the reference's configs/model/ptv3_pitome.gin): PTv3-base with these
``additional_info`` entries."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.additional_info["tome"] = "pitome"
    cfg.additional_info["r"] = 0.52
    cfg.additional_info["margin"] = 0.9
    cfg.additional_info["alpha"] = 1.0
    cfg.additional_info["protected_ratio"] = 0.01
    return cfg
