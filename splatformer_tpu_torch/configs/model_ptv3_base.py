"""PTv3-base model config (copy of splatformer_tpu/configs/model_ptv3_base.py,
whose values mirror the reference's configs/model/ptv3_base.gin), as plain
dataclasses, plus the channel and patch presets of the JAX package's
training/loop.py build_feature_predictor."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

# channel presets of the reference's models/pointtransformer_v3.py:100-126
DEC_CHANNELS = {64: (64, 64, 128, 256), 128: (128, 128, 256, 256),
                96: (96, 96, 128, 256)}
ENC_CHANNELS = {32: (32, 64, 128, 256, 512), 64: (64, 96, 128, 256, 512)}


@dataclass
class BackboneConfig:
    enable_flash: bool = False
    output_dim: int = 96     # -> dec_channels (96, 96, 128, 256)
    enc_dim: int = 64        # -> enc_channels (64, 96, 128, 256, 512)
    turn_off_bn: bool = False
    stride: Tuple[int, ...] = (1, 2, 2, 2)
    embedding_type: str = "MLP"
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_num_head: Tuple[int, ...] = (2, 4, 8, 16, 32)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_num_head: Tuple[int, ...] = (4, 4, 8, 16)
    drop_path: float = 0.3
    mlp_ratio: float = 4.0
    pool_capacity_factors: Tuple[float, ...] = (1.0, 0.75, 0.625, 0.5)
    # explicit overrides (empty tuple / 0 = derive from enc_dim/output_dim/flash)
    enc_channels: Tuple[int, ...] = ()
    dec_channels: Tuple[int, ...] = ()
    patch_size: int = 0

    def backbone_kwargs(self) -> Dict[str, Any]:
        """PointTransformerV3 keyword arguments with the presets resolved."""
        enc = tuple(self.enc_channels) or ENC_CHANNELS[self.enc_dim]
        dec = tuple(self.dec_channels) or DEC_CHANNELS[self.output_dim]
        patch = self.patch_size or (1024 if self.enable_flash else 128)
        return dict(
            enc_depths=tuple(self.enc_depths), enc_channels=enc,
            enc_num_head=tuple(self.enc_num_head),
            enc_patch_size=(patch,) * len(enc),
            dec_depths=tuple(self.dec_depths), dec_channels=dec,
            dec_num_head=tuple(self.dec_num_head),
            dec_patch_size=(patch,) * len(dec),
            stride=tuple(self.stride), mlp_ratio=self.mlp_ratio,
            drop_path=self.drop_path,
            pool_capacity_factors=tuple(self.pool_capacity_factors),
            use_flash=self.enable_flash, turn_off_bn=self.turn_off_bn,
            embedding_type=self.embedding_type)


@dataclass
class ModelConfig:
    backbone_type: str = "PT"
    sh_degree: int = 1
    output_head_nlayer: int = 4
    output_head_type: str = "mlp-relu"
    max_scale_normalized: float = 1e-2
    grid_resolution: int = 384
    # a checkpoint directory whose backbone the loop loads shape-tolerantly
    # when the run has no checkpoint of its own ("" = none)
    resume_ckpt: str = ""
    output_features_type: str = "res"
    input_features: Tuple[str, ...] = ("means", "scales", "opacities", "quats",
                                       "features_dc", "features_rest")
    output_features: Tuple[str, ...] = ("means", "scales", "opacities",
                                        "quats", "features_dc",
                                        "features_rest")
    output_head_width: int = 128
    zeroinit: bool = True
    res_feature_activation: Dict[str, str] = field(default_factory=lambda: {
        "means": "tanh", "features_dc": "identity",
        "features_rest": "identity", "scales": "identity",
        "opacities": "identity", "quats": "identity"})
    input_feat_to_mlp: bool = True
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    # SpUNet's keyword arguments (backbone_type "SP", model_spunet)
    sp_backbone: Dict[str, Any] = field(default_factory=dict)
    additional_info: Dict[str, Any] = field(default_factory=lambda: {
        "tome": "base", "r": 0.0, "tome_mlp": True, "tome_attention": True,
        "trace_back": False, "single_head_tome": False, "margin": 0.9})


def get_config() -> ModelConfig:
    return ModelConfig()
