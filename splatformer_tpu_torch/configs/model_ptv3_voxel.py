"""PTv3 variant 'voxel' (copy of splatformer_tpu/configs/model_ptv3_voxel.py,
after the reference's configs/model/ptv3_voxel.gin): PTv3-base with these
``additional_info`` entries."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.additional_info["downsample"] = "voxel"
    cfg.additional_info["voxel_size"] = 0.0075
    return cfg
