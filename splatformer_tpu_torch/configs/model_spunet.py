"""SpUNet (sparse-conv U-Net) backbone config (copy of
splatformer_tpu/configs/model_spunet.py): PTv3-base's heads over the
reference's alternative backbone, SparseConvModel."""
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.configs.model_ptv3_base import get_config as _base


def get_config() -> ModelConfig:
    cfg = _base()
    cfg.backbone_type = "SP"
    cfg.sp_backbone = dict(
        base_channels=32,
        channels=(32, 64, 128, 256),
        dec_channels=(96, 96, 128),
        depths=(2, 2, 2, 2),
        dec_depths=(1, 1, 1),
        stride=(2, 2, 2),
        pool_capacity_factors=(0.75, 0.625, 0.5),
        output_dim=96,
    )
    return cfg
