"""The model options beside merging, a tiny FeaturePredictor against the
JAX package's on the CPU, eval mode, same weights (helpers of
tests/test_torch_merge_model.py): the PT_embedding stem (a 3^3 sparse conv
in place of the Linear), turn_off_bn (every BatchNorm the identity, no
parameters) and the SpUNet backbone (model_spunet, at a tiny width).
Refined attributes within 1e-4, PSNR within 1e-3 dB, SSIM within 1e-4."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_merge_model import TINY, check_config, infos  # noqa: E402

TINY_SP = dict(base_channels=8, channels=(16, 32), dec_channels=(16,),
               depths=(1, 1), dec_depths=(1,), stride=(2,),
               pool_capacity_factors=(0.75,), output_dim=16)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_pt_embedding():
    bk = dict(TINY, embedding_type="PT_embedding")
    model = check_config(infos("ptv3_base"), bk, bk)
    assert model.backbone.embed_conv_kernel.shape == (27, 23, 16)
    assert not hasattr(model.backbone, "embed_linear")


def test_turn_off_bn():
    bk = dict(TINY, turn_off_bn=True)
    model = check_config(infos("ptv3_base"), bk, bk)
    assert not any(k.endswith((".mean", ".var", ".scale"))
                   for k in model.state_dict())


def test_spunet():
    """model_spunet's heads over SpUNet: no order shuffle, no merging."""
    assert infos("spunet")["tome"] == "base"
    model = check_config(infos("spunet"), TINY_SP, TINY_SP,
                         backbone_type="SP")
    assert model.backbone.out_channels == 16
