"""PTv3 variant 'algm' (copy of splatformer_tpu/configs/model_ptv3_algm.py,
after the reference's configs/model/ptv3_algm.gin): PTv3-base with these
``additional_info`` entries."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.additional_info["tome"] = "algm"
    cfg.additional_info["r"] = 0.5
    cfg.additional_info["threshold"] = 0.9
    return cfg
