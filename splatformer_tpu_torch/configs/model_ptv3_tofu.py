"""PTv3 variant 'tofu' (copy of splatformer_tpu/configs/model_ptv3_tofu.py,
after the reference's configs/model/ptv3_tofu.gin): PTv3-base with these
``additional_info`` entries."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.additional_info["tome"] = "tofu"
    cfg.additional_info["r"] = 0.9
    return cfg
