"""The backbone's diagnostics against the JAX package's on the CPU, eval
mode, same weights (data/convert.py) and scene: each encoder stage's
``enc{s}_n_valid`` and each decoder stage's ``n_valid`` and ``code``
exactly, its ``feat`` within 1e-5, for PTv3 plain, with ToMe in the
attention (r 0.5) and with voxel downsampling (the reduced set's counts);
recording (diagnostics and attention capture) changes no bit of the refined
scene; SpUNet's diagnostics are empty. The tiny backbone of
tests/test_attn_replay.py on a 64-point scene. This file holds the pair
helper of tests/test_torch_attn_replay.py and tests/test_torch_flops.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from splatformer_tpu.data.synthetic import random_scene as jax_random_scene  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    FeaturePredictor, init_weights)
from splatformer_tpu_torch.models.ptv3 import capture_attention  # noqa: E402
from splatformer_tpu_torch.ops.types import GaussianScene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BK = dict(enc_depths=(1, 1), enc_channels=(8, 16), enc_num_head=(2, 2),
          enc_patch_size=(16, 16), dec_depths=(1,), dec_channels=(8,),
          dec_num_head=(2,), dec_patch_size=(16,), stride=(2,),
          drop_path=0.0)
MODEL_KW = dict(sh_degree=1, output_head_width=16, output_head_nlayer=2,
                grid_resolution=32)
ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")
TOME = {"tome": "tome", "r": 0.5, "tome_attention": True}
ALGM = {"tome": "algm", "r": 0.5, "threshold": 0.0, "tome_attention": True}
# an edge of 0.3: ~27 occupied voxels of 64 points, within the capacity
# (0.5 x 64 = 32 rows)
VOXEL = {"downsample": "voxel", "voxel_size": 0.3}


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


_VARIABLES = {}


def jax_scene(seed=0, points=64):
    return jax_random_scene(np.random.default_rng(seed), points, sh_degree=1)


def port_scene(scene):
    return GaussianScene(**{k: torch.from_numpy(np.array(getattr(scene, k)))
                            for k in ATTRS + ("mask",)})


def pair(info, backbone=BK, zeroinit=False):
    """(JAX model, its variables, the port's model on the same weights);
    one JAX init per backbone (merging and downsampling add no
    parameter)."""
    jmodel = JaxFP(additional_info=info, zeroinit=zeroinit,
                   backbone_kwargs=dict(backbone, remat_blocks=False),
                   **MODEL_KW)
    key = (repr(sorted(backbone.items())), zeroinit)
    if key not in _VARIABLES:
        v = jax.jit(lambda k, s: jmodel.init(k, s, False))(
            jax.random.key(0), jax_scene())
        _VARIABLES[key] = jax.tree.map(np.asarray, jax.device_get(v))
    variables = _VARIABLES[key]
    tmodel = FeaturePredictor(additional_info=info, backbone_kwargs=backbone,
                              **MODEL_KW)
    tmodel.load_state_dict(state_dict_from_flax(
        variables["params"], variables.get("batch_stats")), strict=True)
    return jmodel, variables, tmodel.eval()


CASES = {"base": None, "tome": TOME, "voxel": VOXEL}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnostics_match_jax(case):
    info = CASES[case]
    jmodel, variables, tmodel = pair(info)
    scene = jax_scene()
    jdiag = jax.device_get(jax.jit(
        lambda v, s: jmodel.apply(v, s, False)[1])(variables, scene))
    diag = {}
    with torch.inference_mode():
        tmodel(port_scene(scene), diagnostics=diag)
    assert sorted(diag) == sorted(jdiag) == ["enc0_n_valid", "enc1_n_valid",
                                             "intermediates"]
    for s in (0, 1):
        assert diag[f"enc{s}_n_valid"].dtype == torch.int32
        assert int(diag[f"enc{s}_n_valid"]) == int(jdiag[f"enc{s}_n_valid"])
    if case == "voxel":   # the reduced set's counts
        assert int(diag["enc0_n_valid"]) < 64
    else:
        assert int(diag["enc0_n_valid"]) == 64
    assert list(diag["intermediates"]) == list(jdiag["intermediates"]) \
        == ["dec0"]
    got, want = diag["intermediates"]["dec0"], jdiag["intermediates"]["dec0"]
    assert int(got["n_valid"]) == int(want["n_valid"])
    np.testing.assert_array_equal(n(got["code"]), want["code"])
    np.testing.assert_allclose(n(got["feat"]), want["feat"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recording_changes_nothing(case):
    """The refined scene is bit-identical with diagnostics and attention
    capture on and off, and capture switches off after its ``with``."""
    _, _, tmodel = pair(CASES[case])
    scene = port_scene(jax_scene(1))
    with torch.inference_mode():
        plain = tmodel(scene)
        diag = {}
        with capture_attention(tmodel) as recs:
            recorded = tmodel(scene, diagnostics=diag)
    for k in ATTRS:
        assert torch.equal(getattr(plain, k), getattr(recorded, k)), k
    assert sorted(recs) == ["backbone/dec0_block0/attn",
                            "backbone/enc0_block0/attn",
                            "backbone/enc1_block0/attn"]
    assert all(sorted(r) == ["attn_coord", "attn_feat", "attn_in",
                             "attn_inverse", "attn_order"]
               for r in recs.values())
    assert all(m.record is None for m in tmodel.modules()
               if hasattr(m, "record"))


def test_spunet_diagnostics_are_empty():
    from splatformer_tpu_torch.configs import load_config
    cfg = load_config("model", "spunet")
    sp = dict(base_channels=8, channels=(8, 16), dec_channels=(8,),
              depths=(1, 1), dec_depths=(1,), stride=(2,),
              pool_capacity_factors=(1.0,), output_dim=8)
    model = FeaturePredictor(backbone_type="SP", backbone_kwargs=sp,
                             additional_info=cfg.additional_info,
                             **MODEL_KW).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    diag = {}
    with torch.inference_mode():
        out = model(port_scene(jax_scene()), diagnostics=diag)
    assert diag == {} and torch.isfinite(out.means).all()
