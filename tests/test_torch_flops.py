"""The FLOPs profiler (utils/flops.py, calflops.py) against the JAX
package's on the CPU: the analytic helpers for every merge mode x rate in
{0, 0.1, 0.5, 0.9} x tome_attention on and off (pure Python, equal);
``stage_points_from_diagnostics`` of both packages' diagnostics of one
scene (the pair helper of tests/test_torch_diagnostics.py); and the
port's calflops main at a tiny size, whose row equals the JAX functions'
GFLOPs on the same scenes and goes to the given CSV."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from splatformer_tpu.utils import flops as jax_flops  # noqa: E402
from splatformer_tpu_torch import calflops  # noqa: E402
from splatformer_tpu_torch.configs import load_config  # noqa: E402
from splatformer_tpu_torch.ops.merging import MERGE_MODES  # noqa: E402
from splatformer_tpu_torch.utils import flops  # noqa: E402
from test_torch_diagnostics import jax_scene, pair, port_scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# PTv3-base's kwargs and stage counts of a 16,384-point scene, plus a
# ragged stage that leaves a partial patch
BASE_BK = load_config("model", "ptv3_base").backbone.backbone_kwargs()
STAGES = {"enc0": 16384.0, "enc1": 16381.0, "enc2": 12288.0, "enc3": 7680.0,
          "enc4": 3840.0, "dec3": 7680.0, "dec2": 12288.0, "dec1": 16381.0,
          "dec0": 16384.0}


@pytest.mark.parametrize("tome_attention", [True, False])
@pytest.mark.parametrize("r", [0.0, 0.1, 0.5, 0.9])
@pytest.mark.parametrize("mode", ("base",) + MERGE_MODES)
def test_flops_helpers_match_jax(mode, r, tome_attention):
    info = {"tome": mode, "r": r, "tome_attention": tome_attention}
    for patch in (16, 128, 1024):
        assert flops._merge_kprime(patch, info) \
            == jax_flops._merge_kprime(patch, info)
        for n, c, h in ((100.0, 64, 2), (16381.0, 96, 4), (5.0, 512, 32)):
            assert flops.block_attention_flops(n, c, h, patch, info) \
                == jax_flops.block_attention_flops(n, c, h, patch, info)
    assert flops.block_mlp_flops(16381.0, 96) \
        == jax_flops.block_mlp_flops(16381.0, 96)
    got = flops.ptv3_attention_mlp_gflops(BASE_BK, STAGES, info)
    assert got == jax_flops.ptv3_attention_mlp_gflops(BASE_BK, STAGES, info)
    if mode == "base" and r == 0.0:
        # gflops.csv's first row (its scenes give these counts)
        assert got[0] == 41.136996352


def test_stage_points_from_diagnostics_match_jax():
    jmodel, variables, tmodel = pair(None)
    scene = jax_scene(2)
    jdiag = jax.jit(lambda v, s: jmodel.apply(v, s, False)[1])(variables,
                                                               scene)
    diag = {}
    with torch.inference_mode():
        tmodel(port_scene(scene), diagnostics=diag)
    got = flops.stage_points_from_diagnostics(diag)
    assert got == jax_flops.stage_points_from_diagnostics(
        jax.device_get(jdiag))
    assert sorted(got) == ["dec0", "enc0", "enc1"] and got["enc0"] == 64.0


TINY = [
    "dataset.n_gaussians=256", "dataset.pad_to=256",
    "model.backbone.enc_channels=(8, 16)", "model.backbone.dec_channels=(8,)",
    "model.backbone.enc_depths=(1, 1)", "model.backbone.enc_num_head=(2, 2)",
    "model.backbone.dec_depths=(1,)", "model.backbone.dec_num_head=(2,)",
    "model.backbone.stride=(2,)", "model.backbone.patch_size=16",
    "model.backbone.pool_capacity_factors=(0.75,)",
    "model.output_head_width=16", "model.output_head_nlayer=2",
    "model.grid_resolution=32",
]


def test_calflops_main_on_cpu(tmp_path, capsys):
    """ptv3_tome at r 0.5 over 2 scenes: the row's GFLOPs equal the JAX
    functions' on the JAX model's diagnostics of the same scenes; the
    token companion CSV beside it; the default CSV is not the repo's."""
    from splatformer_tpu.configs import build_full_config
    from splatformer_tpu.data.synthetic import random_scene
    from splatformer_tpu.training.loop import build_feature_predictor

    csv = str(tmp_path / "out" / "g.csv")
    args = ["--cpu", "--model", "ptv3_tome", "--merge_rate", "0.5",
            "--num_scenes", "2", "--csv", csv]
    for o in TINY:
        args += ["--override", o]
    assert calflops.main(args) == 0
    assert calflops.main(args + ["--label", "tome_again"]) == 0
    with open(csv) as f:
        rows = [line.strip().split(",") for line in f]
    assert rows[0] == ["gflops", "algo", "r"]
    assert [r[1:] for r in rows[1:]] == [["tome", "0.5"],
                                         ["tome_again", "0.5"]]
    with open(str(tmp_path / "out" / "g_tokens.csv")) as f:
        tokens = [line.strip().split(",") for line in f]
    assert tokens[0] == ["algo", "r", "n_tokens", "n_effective_tokens",
                         "ratio"]
    assert tokens[1][0] == "tome" and int(tokens[1][3]) < int(tokens[1][2])
    assert calflops.DEFAULT_CSV != "gflops.csv" \
        and os.path.dirname(calflops.DEFAULT_CSV)

    cfg = build_full_config("ptv3_tome", "synthetic", "default", TINY)
    cfg.model.additional_info.r = 0.5
    jmodel = build_feature_predictor(cfg.model)
    scenes = [random_scene(np.random.default_rng(i), 256, sh_degree=1)
              for i in range(2)]
    variables = jax.jit(lambda k, s: jmodel.init(k, s, False))(
        jax.random.key(0), scenes[0])
    fwd = jax.jit(lambda s: jmodel.apply(variables, s, False)[1])
    attn = [jax_flops.ptv3_attention_mlp_gflops(
        jmodel.backbone_kwargs, jax_flops.stage_points_from_diagnostics(
            jax.device_get(fwd(s))), dict(cfg.model.additional_info))[0]
        for s in scenes]
    assert float(rows[1][0]) == float(np.mean(attn))
    out = capsys.readouterr().out
    assert "torch_flop_counter_gflops" in out
